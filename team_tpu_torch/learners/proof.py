"""PROOF/TEAM learner, the flagship temporal-evolution-aware trainer
(counterpart of ``team_tpu/learners/proof.py``).

Per task: class and state prototypes from the frozen features, the
projections, fusion attention and context prompts trained with replay on
cached features (CE + CLIP + UniCL), the per-epoch temporal-evolution call
sequence with the state-distance merges, herding rehearsal memory and top-k
evaluation. The reference's per-epoch evolution sequence is kept call for
call, the duplicated every-2-epochs block and the double
``evolve_and_update`` per epoch included: the GCN is not idempotent, so the
repeats change the result.

The epoch is a plain loop over batches, one optimizer step each; the last
batch is padded and masked (``valid_mask``), as in the reference port. The
TPU's ``lax.scan`` over power-of-two chunks of batches was a compile-time
device and has no counterpart here.

``mesh_shape`` lays the ranks out on a mesh (:mod:`team_tpu_torch.parallel`;
one process per device): the state is replicated, each batch is padded to a
multiple of the data axis (masked, never trimmed) and each rank steps on its
rows of it (:func:`proof_net.train_step` under a data group, team_tpu's one
global step), with the fusion dropout's keeps drawn for the global batch and
sliced to the rank's rows; the frozen features are encoded over the ranks
and gathered.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import numpy as np
import torch

from team_tpu_torch.backbone.clip import Params
from team_tpu_torch.bridge import proof_state_from_numpy, tree_to
from team_tpu_torch.config import Config
from team_tpu_torch.learners.backbone_runtime import BackboneRuntime
from team_tpu_torch.learners.base import EVAL_BATCH, BaseLearner
from team_tpu_torch.learners.proof_net import (
    DataShard, ProofBuffers, ProofDims, TaskContext, eval_correct_scan, eval_logits,
    init_buffers, init_proof_params, loss_kwargs, lr_schedule, make_optimizer, project_image,
    project_text, train_step, trainable_leaves)
from team_tpu_torch.modules import lifecycle
from team_tpu_torch.modules.evolution import (
    evolve_and_update, fuse_evolved_prototypes, sync_class_prototypes)
from team_tpu_torch.modules.state_distance import StateDistanceMatrix
from team_tpu_torch.parallel import collectives
from team_tpu_torch.parallel.mesh import (
    MeshContext, allgather_host_shards, host_shard_indices, make_mesh)
from team_tpu_torch.utils.phase_timer import phase
from team_tpu_torch.utils.toolkit import world_rank


def _seed(cfg: Config) -> int:
    return int(cfg.seed[0] if isinstance(cfg.seed, (list, tuple)) else cfg.seed)


class Learner(BaseLearner):
    def __init__(self, cfg: Config, clip_params: Optional[Params] = None,
                 proof_state: Optional[Dict[str, Any]] = None):
        """``clip_params``: the towers' float32 parameters; ``proof_state``:
        ``{"trainable", "aux", "buffers"}`` as numpy-convertible trees (the
        JAX init carried across by :mod:`team_tpu_torch.bridge`). Random
        inits from the config's seed when absent."""
        super().__init__(cfg)
        self.backbone = BackboneRuntime(cfg, params=clip_params)
        self.image_size = self.backbone.clip_cfg.vision.image_size
        self.device = self.backbone.device
        self.tuned_epoch = cfg.tuned_epoch
        self.dims: Optional[ProofDims] = None
        self.trainable: Optional[Dict[str, Any]] = None
        self.aux: Optional[Dict[str, Any]] = None
        self.buffers: Optional[ProofBuffers] = None
        self.ctx: Optional[TaskContext] = None
        self._proof_state = proof_state
        self._init_gen = torch.Generator().manual_seed(_seed(cfg))
        # the fusion dropout's keeps, unless _keep_masks_override provides them
        self._dropout_gen = torch.Generator(device=self.device).manual_seed(_seed(cfg))
        self.state_distance = StateDistanceMatrix(
            num_states=cfg.num_states, feature_dim=self.backbone.out_dim, init_with_prior=True,
            update_interval=cfg.update_state_distance_interval,
            decay_factor=cfg.state_distance_decay_factor)

    # ------------------------------------------------------------------
    @property
    def feature_dim(self) -> int:
        return self.backbone.out_dim

    def extract_vector(self, images):
        return self.backbone.encode_image(images)

    def _extract_vectors(self, loader):
        # NME runs over the task's test loader: serve its cached features
        if loader is self.test_loader and getattr(self, "_test_feats", None) is not None:
            feats, labels, _ = self._test_feats
            return feats.copy(), labels.copy()
        return super()._extract_vectors(loader)

    @torch.no_grad()
    def encode_image(self, images):
        """Image features summed over the task projections."""
        return project_image(self.trainable, self.backbone.encode_image(images), self.ctx,
                             grad_current_only=False)

    @torch.no_grad()
    def encode_text_labels(self, texts):
        return project_text(self.trainable, self.backbone.encode_texts(texts), self.ctx,
                            grad_current_only=False)

    # ------------------------------------------------------------------
    def _ensure_initialized(self, data_manager) -> None:
        if self.dims is not None:
            return
        cfg = self.cfg
        cfg.derive_capacity(data_manager.get_total_classnum(), data_manager.nb_tasks)
        self.dims = ProofDims(
            feature_dim=self.feature_dim, max_classes=cfg.max_classes, max_tasks=cfg.max_tasks,
            num_states=cfg.num_states, ctx_len=cfg.context_prompt_length_per_task,
            gcn_layers=cfg.temporal_gcn_layers if not cfg.parity_mode else 2,
            # parity: the reference always builds hidden = feature_dim // 2
            gcn_hidden_dim=0 if cfg.parity_mode else int(cfg.temporal_gcn_hidden_dim))
        if self.trainable is not None:  # restored from a checkpoint
            tr, aux, buffers = self.trainable, self.aux, self.buffers
        elif self._proof_state is not None:
            tr, aux, buffers = proof_state_from_numpy(self._proof_state, self.device)
            self._proof_state = None
        else:
            tr, aux = init_proof_params(self._init_gen, self.dims,
                                        float(self.backbone.logit_scale))
            tr, aux = tree_to(tr, self.device), tree_to(aux, self.device)
            buffers = init_buffers(self.dims, self.device)
        # an optional mesh: state replicated (rank 0's), batches split over the
        # data axis (replaces the reference's nn.DataParallel, proof.py:312-313)
        self._mesh_ctx: Optional[MeshContext] = None
        clip_shards = 1
        if cfg.mesh_shape:
            mesh = self._mesh_ctx = make_mesh(cfg.mesh_shape, cfg.mesh_axis_names, cfg.device)
            tr, aux = mesh.replicate(tr), mesh.replicate(aux)
            buffers = mesh.replicate(buffers)
            if not cfg.parity_mode and not cfg.global_clip_loss:
                clip_shards = mesh.n_data  # fix mode: the per-shard contrastive loss
        for leaf in trainable_leaves(tr):
            leaf.requires_grad_(True)
        self.trainable, self.aux, self.buffers = tr, aux, buffers
        self._loss_kwargs = loss_kwargs(cfg, self.dims, clip_shards)

    def _make_ctx(self) -> TaskContext:
        t = np.zeros(self.dims.max_tasks, np.float32)
        t[: self._cur_task + 1] = 1.0
        cur = np.zeros(self.dims.max_tasks, np.float32)
        cur[self._cur_task] = 1.0
        cmask = np.zeros(self.dims.max_classes, np.float32)
        cmask[: self._total_classes] = 1.0
        # frozen text features of the first template over the classes seen so far
        template = self.data_manager._data_to_prompt[0]
        labels = self.data_manager._class_to_label[: self._total_classes]
        basic = self.backbone.encode_texts([template.format(lbl) for lbl in labels])
        full = torch.zeros((self.dims.max_classes, self.dims.feature_dim), device=self.device)
        full[: self._total_classes] = basic
        to = self.backbone.to_device
        return TaskContext(task_mask=to(t), cur_onehot=to(cur), class_mask=to(cmask),
                           class_text_basic=full)

    # ------------------------------------------------------------------
    def incremental_train(self, data_manager) -> None:
        self._cur_task += 1
        self._total_classes = self._known_classes + data_manager.get_task_size(self._cur_task)
        self.data_manager = data_manager
        with phase("ensure_initialized"):
            self._ensure_initialized(data_manager)
        with phase("make_ctx_text"):
            self.ctx = self._make_ctx()
        logging.info("Learning on %d-%d", self._known_classes, self._total_classes)

        train_ds = data_manager.get_multimodal_dataset(
            np.arange(self._known_classes, self._total_classes), source="train", mode="train",
            appendent=self._get_memory())
        self.train_dataset = train_ds
        test_ds = data_manager.get_multimodal_dataset(
            np.arange(0, self._total_classes), source="test", mode="test")
        self.test_loader = self._loader(test_ds, batch_size=EVAL_BATCH)
        proto_ds = data_manager.get_multimodal_dataset(
            np.arange(self._known_classes, self._total_classes), source="train", mode="test")

        with phase("prototype"):
            self.cal_prototype(proto_ds)

        # the towers are frozen and the test transforms deterministic, so the
        # task's features are encoded once; a stochastic train pipeline is
        # re-encoded every augment_reencode_every epochs, as the reference
        # re-encodes every epoch
        stochastic = bool(self.cfg.get("augment_ops", None) or not train_ds.deterministic_train)
        self._train_stochastic = stochastic and not self.cfg.get("cache_backbone_features", False)
        with phase("feature_extract_train"):
            if self._train_stochastic:
                self._stoch_loader = self._loader(train_ds, batch_size=EVAL_BATCH)
                self._train_feats = self._extract_vectors_with_states(self._stoch_loader)
            else:
                if stochastic:
                    logging.info("cache_backbone_features=true: the stochastic train pipeline "
                                 "is encoded once per task")
                self._train_feats = self._dataset_features(train_ds)
        with phase("feature_extract_test"):
            self._test_feats = self._dataset_features(test_ds)

        with phase("train_epochs"):
            self._train_proj_with_replay()
        with phase("rehearsal_memory"):
            self.build_rehearsal_memory(data_manager, self.samples_per_class)
        self.state_distance.update_counter = 0
        if self.cfg.enable_plots and world_rank() == 0:
            try:
                from team_tpu_torch.analysis.plots import analyze_state_evolution

                analyze_state_evolution(
                    self.buffers, data_manager._class_to_label,
                    save_dir=f"{self.cfg.results_dir}/task_{self._cur_task}/analysis")
            except Exception as e:  # a plot never stops training
                logging.error("state-evolution analysis failed: %s", e)
        # the final evolution pass
        with phase("evolution"):
            self.integrate_with_state_distance()
            self.evolve_state_prototypes()

    # ------------------------------------------------------------------
    def cal_prototype(self, proto_ds) -> None:
        """Class and (class, state) prototypes: means of the normalized frozen features."""
        feats, labels, stages = self._dataset_features(proto_ds, normalize=True)
        proto_state = self.buffers.proto_state.cpu().numpy()
        proto_mask = self.buffers.proto_mask.cpu().numpy()
        img_protos = self.buffers.img_prototypes.cpu().numpy()
        for class_index in range(self._known_classes, self._total_classes):
            idx = labels == class_index
            if idx.sum() == 0:
                continue
            img_protos[class_index] = feats[idx].mean(axis=0)
            for state_id in np.unique(stages[idx]):
                smask = idx & (stages == state_id)
                proto_state[class_index, int(state_id)] = feats[smask].mean(axis=0)
                proto_mask[class_index, int(state_id)] = 1.0
        # proto_mask is written only here, so whether it is empty is known on the host
        self._proto_mask_any = bool(proto_mask.sum() > 0)
        to = self.backbone.to_device
        self.buffers = self.buffers._replace(img_prototypes=to(img_protos),
                                             proto_state=to(proto_state), proto_mask=to(proto_mask))

    def _dataset_features(self, ds, normalize: bool = False):
        """Frozen features, labels and stage ids of ``ds`` (through the
        run-wide cache where the pipeline is deterministic; there the cache
        splits the encode over the ranks). Outside the cache, several ranks
        each encode their interleaved share of the rows and the shares are
        gathered back into dataset order on every rank."""
        rows = None
        if not self._cacheable(ds) and collectives.group_size() > 1:
            rows = host_shard_indices(len(ds))
        feats, labels, stages = self._extract_vectors_with_states(
            self._loader(ds, batch_size=EVAL_BATCH, indices=rows))
        if rows is not None:
            feats, labels, stages = (allgather_host_shards(a, len(ds))
                                     for a in (feats, labels, stages))
        if normalize:
            feats = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
        return feats, labels, stages

    # ------------------------------------------------------------------
    def _train_proj_with_replay(self) -> None:
        cfg = self.cfg
        tr = self.trainable
        # rebuilt every task, as in the reference; the process's first torch.optim
        # optimizer takes seconds to build, hence a phase of its own
        with phase("make_optimizer"):
            opt = make_optimizer(cfg, trainable_leaves(tr))
        feats, labels, stages = self._train_feats
        n = len(labels)
        shuffle_rng = np.random.default_rng(_seed(cfg) + self._cur_task)
        to = self.backbone.to_device
        feats_d = to(feats.astype(np.float32))
        labels_d, stages_d = to(labels.astype(np.int64)), to(stages.astype(np.int64))

        self.integrate_with_state_distance()  # before training (a no-op in parity mode)
        bs = self.batch_size
        k_full = -(-n // bs)  # the last batch is padded with row 0 and masked
        reencode_every = max(1, int(cfg.get("augment_reencode_every", 1)))
        keep_fn = getattr(self, "_keep_masks_override", None)
        mesh, data = self._mesh_ctx, None
        bs_eff, mine = bs, slice(None)
        if mesh is not None and mesh.n_data > 1:
            data = DataShard(mesh.data_group, mesh.data_rank, mesh.n_data)
            bs_eff = -(-bs // mesh.n_data) * mesh.n_data  # the batch splits over the data axis
            mine = mesh.data_rows(bs_eff)
        for epoch in range(self.tuned_epoch):
            if self._train_stochastic and epoch > 0 and epoch % reencode_every == 0:
                self._train_feats = self._extract_vectors_with_states(self._stoch_loader)
                feats, labels, stages = self._train_feats
                feats_d = to(feats.astype(np.float32))
                labels_d, stages_d = to(labels.astype(np.int64)), to(stages.astype(np.int64))
            for group in opt.param_groups:
                group["lr"] = lr_schedule(cfg, epoch)
            order = shuffle_rng.permutation(n)
            pad = k_full * bs - n
            rows = np.concatenate([order, np.zeros(pad, dtype=order.dtype)]).astype(np.int64)
            vmask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
            # [K, B], then the batch dim padded for the data axis (masked)
            rows = to(np.pad(rows.reshape(k_full, bs), ((0, 0), (0, bs_eff - bs))))
            vmask = to(np.pad(vmask.reshape(k_full, bs), ((0, 0), (0, bs_eff - bs))))

            pending_stats = []
            with phase("epoch_steps"):
                for kb in range(k_full):
                    idx = rows[kb, mine]
                    batch = {"feat": feats_d[idx], "label": labels_d[idx],
                             "stage_id": stages_d[idx], "valid_mask": vmask[kb, mine]}
                    masks = keep_fn(self._cur_task, epoch, kb, k_full) if keep_fn else None
                    if masks is not None:
                        masks = tuple(torch.as_tensor(np.asarray(m), device=self.device)[mine]
                                      for m in masks)
                    st = train_step(tr, opt, batch, self.ctx, self.buffers, epoch,
                                    self._loss_kwargs, keep_masks=masks,
                                    generator=self._dropout_gen, data=data)
                    pending_stats.append(torch.stack([st.total_loss, st.unicl_loss, st.ce_loss,
                                                      st.clip_loss, st.correct.float()]))
                # one host fetch for the epoch's stats; an empty train set has none
                sums = (torch.stack(pending_stats).double().sum(dim=0).tolist() if pending_stats
                        else [0.0] * 5)
            losses, unicl_losses, ce_losses, clip_losses = sums[:4]
            correct = int(sums[4])
            train_acc = np.around(correct * 100 / n, 2) if n else 0.0
            with phase("epoch_test_acc"):
                test_acc = self._compute_accuracy()
            stats_hook = getattr(self, "_epoch_stats_hook", None)
            if stats_hook is not None:  # test-support hook: per-epoch loss components
                stats_hook(self._cur_task, epoch, dict(
                    total=losses, ce=ce_losses, clip=clip_losses, unicl=unicl_losses,
                    correct=correct, n=n))
            nb = max(k_full, 1)
            logging.info("Task %d, Epoch %d/%d => Loss %.3f, UniCL %.3f, Train_acc %.2f, "
                         "Test_acc %.2f", self._cur_task, epoch + 1, self.tuned_epoch,
                         losses / nb, unicl_losses / nb, train_acc, test_acc)

            # the temporal-evolution cadence; fix mode honours temporal_enabled
            if self._temporal_on:
                with phase("epoch_evolution"):
                    last = epoch + 1 == self.tuned_epoch
                    if (epoch + 1) % 2 == 0:
                        self.evolve_state_prototypes()  # block 1
                        if last:
                            self._visualize_evolution_paths()
                        self.evolve_state_prototypes()  # the reference's duplicated block 2
                    if last:
                        self._visualize_evolution_paths()
                    self._apply_evolution(self._evolve())
                    self.update_state_distance_matrix(self.data_manager)

        self.integrate_with_state_distance()  # after training
        self.evolve_state_prototypes()

    # ------------------------------------------------------------------
    def _evo_kwargs(self) -> dict:
        """Fix mode honours the temporal graph's config keys; parity mode keeps
        the reference's hard-coded values."""
        if self.cfg.parity_mode:
            return {}
        return dict(intra_edge_threshold=float(self.cfg.temporal_relation_threshold),
                    inter_edge_weight=0.5 * float(self.cfg.class_lifecycle_consistency),
                    time_weight=float(self.cfg.temporal_feature_weight))

    @property
    def _temporal_on(self) -> bool:
        return self.cfg.parity_mode or bool(self.cfg.temporal_enabled)

    def _evolve(self):
        b = self.buffers
        return evolve_and_update(self.aux["temporal_gcn"], b.proto_state, b.proto_mask,
                                 b.lifecycle_types, **self._evo_kwargs())

    def _apply_evolution(self, res, proto_state=None, img_prototypes=None) -> None:
        self.buffers = self.buffers._replace(
            proto_state=res.prototypes if proto_state is None else proto_state,
            img_prototypes=self.buffers.img_prototypes if img_prototypes is None else img_prototypes,
            evolution_embeddings=res.embeddings, evolution_valid=res.embed_valid,
            lifecycle_types=res.lifecycle_types)

    def _protos_nonempty(self) -> bool:
        flag = getattr(self, "_proto_mask_any", None)
        if flag is None:
            flag = self._proto_mask_any = bool(self.buffers.proto_mask.sum() > 0)
        return flag

    def evolve_state_prototypes(self):
        """Evolve the state prototypes, fuse them with the old ones (the
        reference's aliasing under parity) and resync the class prototypes."""
        if not self._temporal_on or not self._protos_nonempty():
            return None
        b = self.buffers
        res = self._evolve()
        fused = fuse_evolved_prototypes(
            b.proto_state, res.prototypes, b.proto_mask, torch.ones_like(b.proto_mask, dtype=torch.bool),
            parity=self.cfg.parity_mode, alpha=self.cfg.evolution_fuse_alpha)
        img_protos = sync_class_prototypes(fused, b.proto_mask, b.img_prototypes,
                                           self.cfg.adult_state_weight)
        self._apply_evolution(res, proto_state=fused, img_prototypes=img_protos)
        return res.embeddings

    def update_state_distance_matrix(self, data_manager) -> None:
        """One evolution pass, then its state distances merged into the matrix."""
        if not self._temporal_on:
            return
        res = self._evolve()
        self._apply_evolution(res)
        self.state_distance.merge_gcn_distances(res.distances, res.dist_valid,
                                                weight=self.cfg.state_distance_merge_weight)

    def integrate_with_state_distance(self) -> bool:
        """The reference scales evolution-projector biases by state similarity,
        but its projector dict is never filled, so this is a no-op there and in
        parity mode; fix mode acts on the real projectors, with
        ``lifecycle_weight`` as the strength."""
        if self.cfg.parity_mode or not self.cfg.lifecycle_modeling_enabled:
            return True
        if getattr(self, "_evo_projectors", None) is None:
            self._evo_projectors = tree_to(
                lifecycle.init_evolution_projectors(self._init_gen, self.dims.feature_dim),
                self.device)
        self._evo_projectors = lifecycle.integrate_with_state_distance(
            self._evo_projectors, self.state_distance.get_distance_matrix(),
            scale=float(self.cfg.lifecycle_weight))
        return True

    def evolution_trajectory(self, src_state: int, src_feat):
        """The src→adult feature trajectory over the fix-mode projectors, with
        ``state_evolution_steps`` steps."""
        if getattr(self, "_evo_projectors", None) is None:
            return None
        return lifecycle.evolution_trajectory(self._evo_projectors, src_state, src_feat,
                                              num_steps=max(2, int(self.cfg.state_evolution_steps)))

    def _visualize_evolution_paths(self) -> None:
        """Under ``enable_plots``, each class's PCA path (rank 0 draws)."""
        if not self.cfg.enable_plots or world_rank() != 0:
            return
        try:
            from team_tpu_torch.analysis.plots import visualize_evolution_path

            visualize_evolution_path(
                self.buffers, save_dir=f"{self.cfg.results_dir}/task_{self._cur_task}/evolution")
        except Exception as e:  # a plot never stops training
            logging.error("evolution-path visualization failed: %s", e)

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _eval_zero_shot(self):
        """Zero-shot over the whole test set; its frozen features are cached
        once for the run (only the projections change per task)."""
        total = self.data_manager.get_total_classnum()
        if getattr(self, "_zs_feats", None) is None:
            ds = self.data_manager.get_dataset(np.arange(0, total), source="test", mode="test")
            self._zs_feats = self._dataset_features(ds)[:2]
        text_features = self._zero_shot_text_features()
        feats, labels = self._zs_feats
        img = project_image(self.trainable, self.backbone.to_device(feats), self.ctx,
                            grad_current_only=False)
        img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
        logits = img @ text_features.T
        k = min(self.topk, logits.shape[1])
        return logits.topk(k, dim=1).indices.cpu().numpy(), np.asarray(labels)

    def _compute_accuracy(self) -> float:
        feats, labels, _ = self._test_feats
        to = self.backbone.to_device
        correct = int(eval_correct_scan(self.trainable, to(feats), to(labels.astype(np.int64)),
                                        self.ctx))
        return float(np.around(correct * 100 / len(labels), decimals=2))

    def _eval_cnn(self, loader):
        k = min(self.topk, self._total_classes)

        def scores(basic):
            return eval_logits(self.trainable, basic, self.ctx)

        if loader is not self.test_loader or getattr(self, "_test_feats", None) is None:
            return self._topk_predictions(loader, scores, k)
        # the task's test loader: its frozen features are cached
        feats, labels, _ = self._test_feats
        preds = scores(self.backbone.to_device(feats)).topk(k, dim=1).indices.cpu().numpy()
        if k < self.topk:
            preds = np.concatenate([preds, np.zeros((len(preds), self.topk - k), preds.dtype)], axis=1)
        return preds, labels
