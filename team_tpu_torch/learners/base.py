"""Base class-incremental learner: the evaluation harness and the rehearsal
memory.

Counterpart of ``team_tpu/learners/base.py``: the loader, the run-wide
frozen-feature cache, top-k, NME and template-ensembled zero-shot evaluation,
and herding-based rehearsal memory (global and per state), with the stage
ids travelling beside the exemplars.

Per-batch device results are gathered with one ``torch.cat`` on the device
and one copy to the host.
"""

from __future__ import annotations

import hashlib
import logging
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from team_tpu_torch.config import Config
from team_tpu_torch.data import ArrayLoader, DataManager, native_io
from team_tpu_torch.parallel import collectives
from team_tpu_torch.parallel.mesh import allgather_host_shards, host_shard_indices
from team_tpu_torch.utils.phase_timer import phase
from team_tpu_torch.utils.toolkit import accuracy, topk_accuracy

EPSILON = 1e-8
EVAL_BATCH = 128


def _gather_rows(pending) -> np.ndarray:
    """``[(valid, tensor [B, ...]), ...]`` -> the valid rows of every batch,
    concatenated on the host."""
    if not pending:
        return np.zeros((0, 1), np.float32)
    return torch.cat([t[:v] for v, t in pending]).cpu().numpy()


class BaseLearner:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        self._cur_task = -1
        self._known_classes = 0
        self._total_classes = 0
        self._data_memory: np.ndarray = np.array([])
        self._targets_memory: np.ndarray = np.array([])
        self._stages_memory: np.ndarray = np.array([])
        self.topk = 4  # reported as "top5" by the trainer (the reference's quirk)
        self._memory_size = cfg.memory_size
        self._memory_per_class = cfg.memory_per_class
        self._fixed_memory = cfg.fixed_memory
        self.batch_size = cfg.batch_size
        self.image_size = 224  # overridden by learners from the backbone config
        self.data_manager: Optional[DataManager] = None
        self.test_loader: Optional[ArrayLoader] = None

    # ------------------------------------------------------------------
    @property
    def exemplar_size(self) -> int:
        if len(self._data_memory) != len(self._targets_memory):
            raise ValueError("Exemplar size error.")
        return len(self._targets_memory)

    @property
    def samples_per_class(self) -> int:
        if self._fixed_memory:
            return self._memory_per_class
        if self._total_classes == 0:
            raise ValueError("Total classes is 0")
        return self._memory_size // self._total_classes

    @property
    def feature_dim(self) -> int:
        raise NotImplementedError

    def _get_memory(self):
        if len(self._data_memory) == 0:
            return None
        return (self._data_memory, self._targets_memory, self._stages_memory)

    # -- subclass hooks -------------------------------------------------
    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """Learner-level image embedding."""
        raise NotImplementedError

    def encode_text_labels(self, texts) -> torch.Tensor:
        """Learner-level text embedding for a list of strings."""
        raise NotImplementedError

    def extract_vector(self, images: torch.Tensor) -> torch.Tensor:
        """Frozen-backbone feature."""
        raise NotImplementedError

    def incremental_train(self, data_manager: DataManager) -> None:
        raise NotImplementedError

    def after_task(self) -> None:
        self._known_classes = self._total_classes
        logging.info("Exemplar size: %d", self.exemplar_size)

    # ------------------------------------------------------------------
    def _loader(self, dataset, shuffle=False, batch_size=None, pad_last=True,
                indices=None) -> ArrayLoader:
        # pad_last keeps one batch shape per consumer, as in team_tpu;
        # consumers slice [:valid]
        seed = self.cfg.seed[0] if isinstance(self.cfg.seed, (list, tuple)) else self.cfg.seed
        return ArrayLoader(
            dataset,
            batch_size or self.batch_size,
            shuffle=shuffle,
            seed=int(seed),
            num_threads=self.cfg.num_io_threads,
            image_size=self.image_size,
            use_native=bool(self.cfg.get("use_native_io", False)),
            augment_ops=self.cfg.get("augment_ops", None),
            pad_last=pad_last,
            indices=indices,
            device_normalize=bool(self.cfg.get("device_preprocess", True)),
            patch_major=bool(self.cfg.get("patch_major_io", False)),
            patch_size=self.backbone.clip_cfg.vision.patch_size,
        )

    # ------------------------------------------------------------------
    # frozen-feature cache: the backbone is frozen and the CLIP preprocess is
    # deterministic, so each image's feature is computed at most once per run
    # (keyed by path or content hash)
    # ------------------------------------------------------------------
    def _cacheable(self, ds) -> bool:
        if self.cfg.get("cache_backbone_features", False):
            # explicit opt-in: the first augmentation draws are frozen for the run
            return True
        if self.cfg.get("augment_ops", None):
            return False
        if ds.mode == "train" and not ds.deterministic_train:
            return False  # random-crop pipeline: features differ per epoch
        return True

    def _feat_keys(self, ds):
        cached = getattr(ds, "_feat_keys_memo", None)
        if cached is not None:
            return cached
        # deterministic-train datasets share the CLIP transform between train
        # and test modes, so those modes share cache entries; "flip" differs
        mode_key = "flip" if ds.mode == "flip" else "clip"
        if ds.use_path:
            keys = [(mode_key, str(p)) for p in ds.images]
        else:
            keys = []
            for arr in ds.images:
                a = np.ascontiguousarray(arr)
                keys.append((mode_key, a.shape, hashlib.md5(a.tobytes()).hexdigest()))
        ds._feat_keys_memo = keys
        return keys

    def _cached_features(self, ds, batch_size=EVAL_BATCH) -> np.ndarray:
        """Frozen features for every row of ``ds``, encoding only the rows the
        run-wide cache does not hold yet. Under several ranks the missing
        rows (the same on every rank: the cache evolves deterministically)
        are split over the ranks, each encodes its share, and the shares are
        gathered into every rank's cache, so the run still encodes each image
        once (``team_tpu/learners/base.py:186-238``)."""
        cache = getattr(self, "_feature_cache", None)
        if cache is None:
            cache = self._feature_cache = {}
        keys = self._feat_keys(ds)
        missing = np.asarray([i for i, k in enumerate(keys) if k not in cache], dtype=np.int64)
        if len(missing):
            multi = collectives.group_size() > 1
            share = missing[host_shard_indices(len(missing))] if multi else missing
            pending = []
            if len(share):
                loader = self._loader(ds, batch_size=batch_size, indices=share)
                with phase("cache_fill_dispatch"):
                    for batch in loader:
                        v = int(batch.get("valid", len(batch["label"])))
                        pending.append((v, self.extract_vector(
                            self.backbone.to_device(batch["image"]))))
            with phase("cache_fill_fetch"):
                feats = (_gather_rows(pending) if pending
                         else np.zeros((0, self.feature_dim), np.float32))
                if multi:
                    feats = allgather_host_shards(feats, len(missing))
            # the loader serves its rows in order, so feats[i] is missing[i]'s (or share[i]'s)
            for row, f in zip(missing if multi else share, feats):
                cache[keys[int(row)]] = f
        return np.stack([cache[k] for k in keys])

    def _extract_vectors(self, loader: ArrayLoader) -> Tuple[np.ndarray, np.ndarray]:
        ds = loader.dataset
        if loader.indices is None and self._cacheable(ds):
            return self._cached_features(ds, loader.batch_size), ds.labels
        pending, targets = [], []
        for b in loader:
            v = int(b.get("valid", len(b["label"])))
            pending.append((v, self.extract_vector(self.backbone.to_device(b["image"]))))
            targets.append(b["label"][:v])
        return _gather_rows(pending), np.concatenate(targets)

    def _extract_vectors_with_states(self, loader: ArrayLoader):
        ds = loader.dataset
        if loader.indices is None and self._cacheable(ds):
            return self._cached_features(ds, loader.batch_size), ds.labels, ds.stages
        pending, targets, states = [], [], []
        for b in loader:
            v = int(b.get("valid", len(b["label"])))
            pending.append((v, self.extract_vector(self.backbone.to_device(b["image"]))))
            targets.append(b["label"][:v])
            states.append(b["stage_id"][:v])
        return _gather_rows(pending), np.concatenate(targets), np.concatenate(states)

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def _evaluate(self, y_pred: np.ndarray, y_true: np.ndarray) -> Dict:
        grouped = accuracy(y_pred.T[0], y_true, self._known_classes)
        ret = {"grouped": grouped, "top1": grouped["total"]}
        ret[f"top{self.topk}"] = topk_accuracy(y_pred[:, : self.topk], y_true)
        return ret

    def _evaluate_zs(self, y_pred: np.ndarray, y_true: np.ndarray) -> Dict:
        grouped = accuracy(y_pred.T[0], y_true, self._total_classes)
        ret = {"grouped": grouped, "top1": grouped["total"]}
        if y_pred.shape[1] < self.topk:
            # fewer classes than topk: pad with -1 columns (never a label)
            pad = np.full((y_pred.shape[0], self.topk - y_pred.shape[1]), -1, y_pred.dtype)
            y_pred = np.concatenate([y_pred, pad], axis=1)
        ret[f"top{self.topk}"] = np.around(
            (y_pred.T == np.tile(y_true, (self.topk, 1))).sum() * 100 / len(y_true), decimals=2
        )
        return ret

    def eval_task(self):
        with phase("eval_cnn"):
            y_pred, y_true = self._eval_cnn(self.test_loader)
            cnn_accy = self._evaluate(y_pred, y_true)

        if getattr(self, "_class_means", None) is not None:
            with phase("eval_nme"):
                y_pred, y_true = self._eval_nme(self.test_loader, self._class_means)
                nme_accy = self._evaluate(y_pred, y_true)
        else:
            nme_accy = None

        with phase("eval_zero_shot"):
            y_pred, y_true = self._eval_zero_shot()
            zs = self._evaluate_zs(y_pred, y_true)
        g = zs["grouped"]
        return cnn_accy, nme_accy, g["old"], g["new"], g["harmonic"], g["total"]

    def _eval_cnn(self, loader: ArrayLoader):
        raise NotImplementedError

    def _topk_predictions(self, loader: ArrayLoader, scores_fn, k: int):
        """``[N, topk]`` class predictions of ``scores_fn(features)`` over the
        loader; columns past ``k`` (fewer classes than topk) are 0."""
        pending, y_true = [], []
        for batch in loader:
            v = int(batch.get("valid", len(batch["label"])))
            logits = scores_fn(self.extract_vector(self.backbone.to_device(batch["image"])))
            pending.append((v, logits.topk(k, dim=1).indices))
            y_true.append(batch["label"][:v])
        preds = _gather_rows(pending)
        if k < self.topk:
            preds = np.concatenate(
                [preds, np.zeros((preds.shape[0], self.topk - k), dtype=preds.dtype)], axis=1)
        return preds, np.concatenate(y_true)

    def _eval_nme(self, loader: ArrayLoader, class_means: np.ndarray):
        vectors, y_true = self._extract_vectors(loader)
        vectors = (vectors.T / (np.linalg.norm(vectors.T, axis=0) + EPSILON)).T
        # pad the means to the dataset's class count with far-away rows, as
        # team_tpu does, so both give predictions of the same width
        total = (self.data_manager.get_total_classnum()
                 if self.data_manager is not None else len(class_means))
        if len(class_means) < total:
            pad = np.full((total - len(class_means), class_means.shape[1]), 1e6,
                          dtype=class_means.dtype)
            class_means = np.concatenate([class_means, pad])
        means = self.backbone.to_device(class_means.astype(np.float32))  # float32, as in team_tpu
        scores = _sq_euclidean(means, self.backbone.to_device(vectors)).T.cpu().numpy()
        return np.argsort(scores, axis=1)[:, : self.topk], y_true

    def _zero_shot_text_features(self) -> torch.Tensor:
        """Template-ensembled per-class text features over all dataset classes."""
        class_to_label = self.data_manager._class_to_label
        templates = self.data_manager._data_to_prompt
        feats = []
        for label in class_to_label:
            emb = self.encode_text_labels([t.format(label) for t in templates])
            emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
            mean = emb.mean(dim=0)
            feats.append(mean / torch.linalg.vector_norm(mean))
        return torch.stack(feats)

    def _eval_zero_shot(self):
        text_features = self._zero_shot_text_features()
        total = self.data_manager.get_total_classnum()
        ds = self.data_manager.get_dataset(np.arange(0, total), source="test", mode="test")
        loader = self._loader(ds, batch_size=EVAL_BATCH)
        pending, y_true = [], []
        k = min(self.topk, text_features.shape[0])
        for batch in loader:
            v = int(batch.get("valid", len(batch["label"])))
            img = self.encode_image(self.backbone.to_device(batch["image"]))
            img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
            pending.append((v, (img @ text_features.T).topk(k, dim=1).indices))
            y_true.append(batch["label"][:v])
        return _gather_rows(pending), np.concatenate(y_true)


    # ------------------------------------------------------------------
    # rehearsal memory (herding)
    # ------------------------------------------------------------------
    def build_rehearsal_memory(self, data_manager: DataManager, per_class: int) -> None:
        # fix mode honours stage_first_replay: per-state herding keeps every
        # lifecycle stage represented, under a total budget too
        stage_first = (not self.cfg.parity_mode) and bool(self.cfg.stage_first_replay)
        if self._fixed_memory or stage_first:
            if not self._fixed_memory:
                # a total budget shrinks the old classes' quotas: trim them first
                self._reduce_exemplar(data_manager, per_class)
            self._construct_exemplar_unified(data_manager, per_class,
                                             budget_exact=not self._fixed_memory)
        else:
            self._reduce_exemplar(data_manager, per_class)
            self._construct_exemplar(data_manager, per_class)

    def _select_exemplars(self, vectors: np.ndarray, class_mean: np.ndarray, m: int) -> np.ndarray:
        """``exemplar_selection_strategy`` in fix mode (parity mode always
        herds): ``herding``, ``random`` (seeded) or ``closest`` to the mean."""
        strategy = "herding" if self.cfg.parity_mode else str(
            self.cfg.exemplar_selection_strategy).lower()
        m = min(m, len(vectors))
        if strategy == "random":
            seed = self.cfg.seed[0] if isinstance(self.cfg.seed, (list, tuple)) else self.cfg.seed
            rng = np.random.default_rng(int(seed) + len(self._targets_memory))
            return rng.choice(len(vectors), size=m, replace=False)
        if strategy in ("closest", "closest_to_mean"):
            return np.argsort(np.linalg.norm(vectors - class_mean[None], axis=1))[:m]
        if self.cfg.get("use_native_io", False) and native_io.available():
            # the C++ herding of native/team_io.cc: the same indices as the numpy loop
            return native_io.herding(vectors, class_mean, m)
        return herding_selection(vectors, class_mean, m)

    def _class_mean_of(self, data_manager, appendent) -> np.ndarray:
        ds = data_manager.get_dataset([], source="train", mode="test", appendent=appendent)
        vectors, _ = self._extract_vectors(self._loader(ds, batch_size=EVAL_BATCH))
        vectors = (vectors.T / (np.linalg.norm(vectors.T, axis=0) + EPSILON)).T
        mean = np.mean(vectors, axis=0)
        return mean / np.linalg.norm(mean)

    def _reduce_exemplar(self, data_manager: DataManager, m: int) -> None:
        logging.info("Reducing exemplars...(%d per classes)", m)
        dummy_data = self._data_memory.copy()
        dummy_targets = self._targets_memory.copy()
        dummy_stages = self._stages_memory.copy()
        self._class_means = np.zeros((self._total_classes, self.feature_dim))
        self._data_memory = np.array([])
        self._targets_memory = np.array([])
        self._stages_memory = np.array([])
        for class_idx in range(self._known_classes):
            mask = np.where(dummy_targets == class_idx)[0]
            dd, dt, dstg = dummy_data[mask][:m], dummy_targets[mask][:m], dummy_stages[mask][:m]
            self._append_memory(dd, dt, dstg)
            self._class_means[class_idx, :] = self._class_mean_of(data_manager, (dd, dt, dstg))

    def _construct_exemplar(self, data_manager: DataManager, m: int) -> None:
        logging.info("Constructing exemplars...(%d per classes)", m)
        for class_idx in range(self._known_classes, self._total_classes):
            data, _, ds = data_manager.get_dataset(
                np.arange(class_idx, class_idx + 1), source="train", mode="test", ret_data=True)
            vectors, _ = self._extract_vectors(self._loader(ds, batch_size=EVAL_BATCH))
            vectors = (vectors.T / (np.linalg.norm(vectors.T, axis=0) + EPSILON)).T
            sel_idx = self._select_exemplars(vectors, np.mean(vectors, axis=0), m)
            selected = np.asarray(data)[sel_idx]
            sel_stages = ds.stages[sel_idx]
            exemplar_targets = np.full(len(sel_idx), class_idx)
            self._append_memory(selected, exemplar_targets, sel_stages)
            self._class_means[class_idx, :] = self._class_mean_of(
                data_manager, (selected, exemplar_targets, sel_stages))

    def _construct_exemplar_unified(self, data_manager: DataManager, m: int,
                                    budget_exact: bool = False) -> None:
        """Per-state herding. ``budget_exact`` (stage_first_replay under a
        total budget): per-state quotas that sum to exactly ``m``, extras to
        the lower state ids, instead of the reference's ``max(m // n, 1)``,
        which exceeds the class quota when a class has more states than slots."""
        logging.info("Constructing per-state exemplars (up to %d per class)", m)
        if not hasattr(self, "_data_memory_by_state"):
            self._data_memory_by_state: Dict = {}
            self._targets_memory_by_state: Dict = {}
        class_means = np.zeros((self._total_classes, self.feature_dim))
        for class_idx in range(self._known_classes):
            mask = np.where(self._targets_memory == class_idx)[0]
            app = (self._data_memory[mask], self._targets_memory[mask], self._stages_memory[mask])
            class_means[class_idx, :] = self._class_mean_of(data_manager, app)

        for class_idx in range(self._known_classes, self._total_classes):
            data, _, ds = data_manager.get_multimodal_dataset(
                np.arange(class_idx, class_idx + 1), source="train", mode="test", ret_data=True)
            vectors, _, state_ids = self._extract_vectors_with_states(
                self._loader(ds, batch_size=EVAL_BATCH))
            vectors = (vectors.T / (np.linalg.norm(vectors.T, axis=0) + EPSILON)).T
            unique_states = np.unique(state_ids)
            n_states = len(unique_states)
            if budget_exact:
                quotas = np.full(n_states, m // n_states, np.int64)
                quotas[: m % n_states] += 1
                if m < n_states:
                    logging.warning("stage_first_replay: class %d has %d states but only %d "
                                    "exemplar slots; %d state(s) unrepresented",
                                    class_idx, n_states, m, n_states - m)
            else:
                quotas = np.full(n_states, max(m // n_states, 1), np.int64)
            self._data_memory_by_state.setdefault(class_idx, {})
            self._targets_memory_by_state.setdefault(class_idx, {})
            for state_id, quota in zip(unique_states, quotas):
                if quota == 0:
                    continue
                smask = state_ids == state_id
                sv, sd = vectors[smask], np.asarray(data)[smask]
                if len(sv) <= quota:
                    selected = sd
                else:
                    selected = sd[self._select_exemplars(sv, np.mean(sv, axis=0), quota)]
                ex_targets = np.full(len(selected), class_idx)
                self._data_memory_by_state[class_idx][int(state_id)] = selected
                self._targets_memory_by_state[class_idx][int(state_id)] = ex_targets
                self._append_memory(selected, ex_targets, np.full(len(selected), state_id))
            cmask = np.where(self._targets_memory == class_idx)[0]
            app = (self._data_memory[cmask], self._targets_memory[cmask], self._stages_memory[cmask])
            class_means[class_idx, :] = self._class_mean_of(data_manager, app)
        self._class_means = class_means

    def _append_memory(self, data, targets, stages) -> None:
        def cat(old, new):
            return np.concatenate((old, new)) if len(old) else np.asarray(new)

        self._data_memory = cat(self._data_memory, data)
        self._targets_memory = cat(self._targets_memory, targets)
        self._stages_memory = cat(self._stages_memory, stages)


def herding_selection(vectors: np.ndarray, class_mean: np.ndarray, m: int) -> np.ndarray:
    """iCaRL herding: greedily pick the sample whose inclusion keeps the
    running exemplar mean closest to the class mean. Returns indices into the
    original ``vectors`` order."""
    m = min(m, len(vectors))
    remaining = np.arange(len(vectors))
    work = vectors.copy()
    running = np.zeros_like(class_mean)
    chosen = []
    for k in range(1, m + 1):
        mu_p = (work + running) / k
        i = int(np.argmin(np.sqrt(np.sum((class_mean - mu_p) ** 2, axis=1))))
        chosen.append(remaining[i])
        running = running + work[i]
        work = np.delete(work, i, axis=0)
        remaining = np.delete(remaining, i)
    return np.asarray(chosen)


def _sq_euclidean(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cdist(a, b, 'sqeuclidean') on the device."""
    a2 = (a * a).sum(dim=1)[:, None]
    b2 = (b * b).sum(dim=1)[None, :]
    return a2 + b2 - 2.0 * (a @ b.T)
