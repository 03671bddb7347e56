"""Configuration surface for TEAM-TPU (the port's own copy of
``team_tpu/config.py``, which is framework-free).

Keeps the exact JSON experiment-file schema of the reference
(``exps/IIMinsects202.json:1-47``) plus the CLI keys merged by ``main.py:12-16``
(JSON overrides CLI).

The reference declares many JSON keys it never reads (e.g. it hard-codes the
UniCL weights at ``models/proof.py:173-175`` and temperature 0.07 at ``:22``).
Here ``parity_mode=True`` (default) reproduces the reference's hard-coded
behavior; fix mode (``parity_mode=False``) HONORS the declared knobs, each wired
to the module that owns it (tests/test_fix_mode.py):

* ``temperature`` / ``unicl_instance_weight`` / ``unicl_category_weight`` — UniCL;
* ``lr_scheduler`` / ``milestones`` / ``gamma`` — per-epoch LR schedule;
* ``exemplar_selection_strategy`` (herding|random|closest), ``stage_first_replay``
  — rehearsal memory construction;
* ``temporal_enabled`` — gates the whole evolution cadence;
* ``temporal_relation_threshold`` / ``class_lifecycle_consistency`` /
  ``temporal_feature_weight`` — temporal-graph edges and time features;
* ``lifecycle_modeling_enabled`` / ``lifecycle_weight`` / ``state_evolution_steps``
  — real evolution projectors (``modules/lifecycle.py``);
* ``temporal_gcn_layers`` / ``temporal_gcn_hidden_dim`` — GCN capacity;
* ``global_clip_loss`` — global vs per-shard contrastive loss under a mesh;
* ``update_state_distance_interval`` / ``state_distance_decay_factor`` — EMA gate.

Schema-compat ONLY (accepted, stored, deliberately not interpreted — they have
no behavior in the reference and no natural owner here): ``balanced``, ``zoom``,
``exemplars_per_class`` (superseded by ``memory_per_class``), ``model_dir``
(superseded by ``checkpoint_dir``), ``frozen_layers``, ``use_cos``, and the CLI
flags ``debug`` / ``temporal`` (superseded by ``temporal_enabled``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import Any, Dict, Optional, Sequence


def get_attribute(dic: Dict[str, Any], name: str, default: Any) -> Any:
    """Config getter that logs defaults (reference ``utils/toolkit.py:66-71``)."""
    if name in dic:
        return dic[name]
    logging.info("%s not in args, set to %r as default", name, default)
    return default


@dataclasses.dataclass
class Config:
    """Full experiment configuration.

    Field names mirror the reference JSON schema so existing experiment files load
    unchanged; TPU-specific fields are additive and default to sane values.
    """

    # --- experiment identity -------------------------------------------------
    prefix: str = "experiment"
    dataset: str = "iiminsects202"
    model_name: str = "proof"            # proof | simplecil | zs_clip
    convnet_type: str = "clip"           # clip | clip_laion2b | openai_clip
    seed: Sequence[int] = (42,)
    device: Sequence[int] = (0,)

    # --- incremental protocol ------------------------------------------------
    init_cls: int = 2
    increment: int = 2
    shuffle: bool = True

    # --- rehearsal memory ----------------------------------------------------
    memory_size: int = 120
    memory_per_class: int = 40
    fixed_memory: bool = False

    # --- optimization --------------------------------------------------------
    tuned_epoch: int = 20
    batch_size: int = 16
    optimizer: str = "adam"              # sgd | adam (AdamW, reference proof.py:358-361)
    init_lr: float = 0.004
    min_lr: float = 0.0
    weight_decay: float = 5e-5
    momentum: float = 0.9
    lr_scheduler: str = "cosine"
    milestones: Sequence[int] = (200, 280)
    gamma: float = 0.2

    # --- PROOF / TEAM architecture ------------------------------------------
    projection_type: str = "pure_mlp"
    context_prompt_length_per_task: int = 10
    temperature: float = 0.07            # UniCL temperature (reference default, proof.py:22)
    unicl_instance_weight: float = 1.0   # reference hard-codes 1.0 (proof.py:173)
    unicl_category_weight: float = 0.5   # reference hard-codes 0.5 (proof.py:174)
    unicl_loss_weight: float = 0.3       # total = ce + clip + w*unicl (proof.py:442)

    # --- temporal evolution stack -------------------------------------------
    temporal_enabled: bool = True
    temporal_gcn_layers: int = 2         # reference TemporalStateGCN num_layers=2
    temporal_gcn_hidden_dim: int = 256   # reference: feature_dim // 2
    num_states: int = 10
    lifecycle_modeling_enabled: bool = True
    lifecycle_weight: float = 0.4
    temporal_relation_threshold: float = 0.2
    class_lifecycle_consistency: float = 0.7
    temporal_feature_weight: float = 0.25
    state_evolution_steps: int = 5
    update_state_distance_interval: int = 1
    state_distance_decay_factor: float = 0.9
    state_distance_merge_weight: float = 0.3  # GCN-merge weight (proof.py:672)
    evolution_fuse_alpha: float = 0.6         # original/evolved fuse (inc_net.py:589)
    adult_state_weight: float = 1.5           # class-proto sync weight for state 4 (inc_net.py:610)

    # --- misc reference keys (kept for schema compat) ------------------------
    balanced: bool = True
    stage_first_replay: bool = True
    exemplars_per_class: int = 5
    exemplar_selection_strategy: str = "herding"
    zoom: float = 0.15
    model_dir: str = "logs"
    frozen_layers: Optional[Any] = None
    use_cos: bool = False

    # --- TPU-native knobs (additive) -----------------------------------------
    parity_mode: bool = True             # reproduce reference quirks exactly (no-grad CE, temp 0.07, ...)
    max_classes: int = 0                 # 0 -> derived from dataset
    max_tasks: int = 0                   # 0 -> derived from protocol
    attention_impl: str = "auto"         # auto | pallas | xla
    compute_dtype: str = "float32"       # float32 | bfloat16 (backbone compute)
    # frozen-backbone image-encode tier: bf16 | int8_static (calibrated
    # static-W8A8 tower, ~1.5x encode throughput, cosine >= 0.999 gate at
    # first use — replaces the reference's external CUDA encoder tier,
    # utils/inc_net.py:19-32; docs/BENCH.md round 3)
    encoder_quant: str = "bf16"
    cache_backbone_features: bool = False  # cache frozen features across epochs (breaks aug parity)
    # stochastic train pipelines (augment_ops / RandomResizedCrop datasets):
    # re-encode the train set every N epochs so augmentation is re-sampled as
    # the reference does every epoch (models/proof.py:397-412). 1 = every epoch.
    augment_reencode_every: int = 1
    mesh_shape: Optional[Sequence[int]] = None  # e.g. [8] for 1-D data mesh
    mesh_axis_names: Sequence[str] = ("data",)
    global_clip_loss: bool = True        # all_gather features across the data axis
    local_loss: bool = False             # open_clip-style local-loss variant
    device_preprocess: bool = True       # host stops at uint8; /255+normalize fused on device
    data_root: Optional[str] = None      # dataset root (replaces hardcoded paths, data.py:493-494)
    log_dir: str = "logs"
    results_dir: str = "results"
    checkpoint_dir: Optional[str] = None # per-task torch.save checkpoints when set (checkpoint.py)
    resume: bool = False
    profile_dir: Optional[str] = None    # torch.profiler traces when set (analysis/profiler.py)
    enable_plots: bool = False           # host-side matplotlib artifacts
    num_io_threads: int = 8              # native loader threads (reference num_workers=8)
    vision_model: str = "ViT-B-16"
    debug: bool = False
    temporal: bool = True
    name: str = ""

    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------
    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Config":
        field_names = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in raw.items() if k in field_names}
        extras = {k: v for k, v in raw.items() if k not in field_names}
        cfg = cls(**known)
        cfg.extras = extras
        if isinstance(cfg.seed, int):
            cfg.seed = [cfg.seed]
        if isinstance(cfg.device, int):
            cfg.device = [cfg.device]
        return cfg

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.update(d.pop("extras"))
        return d

    def get(self, name: str, default: Any = None) -> Any:
        if hasattr(self, name):
            return getattr(self, name)
        return get_attribute(self.extras, name, default)

    # Convenience dict-style access so learners can treat Config like args.
    def __getitem__(self, name: str) -> Any:
        if hasattr(self, name):
            return getattr(self, name)
        return self.extras[name]

    def __contains__(self, name: str) -> bool:
        return hasattr(self, name) or name in self.extras

    def derive_capacity(self, total_classes: int, nb_tasks: int) -> None:
        """Fill max_classes / max_tasks from the dataset protocol when unset."""
        if not self.max_classes:
            self.max_classes = total_classes
        if not self.max_tasks:
            self.max_tasks = nb_tasks


def load_config(path: str, overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Load a JSON experiment file; JSON wins over CLI overrides
    (matching reference ``main.py:14-16`` ``args.update(param)`` semantics)."""
    base: Dict[str, Any] = dict(overrides or {})
    with open(path, "r", encoding="utf-8") as f:
        base.update(json.load(f))
    return Config.from_dict(base)
