"""PROOF/TEAM network: the functional forward, the loss and the train step
(counterpart of ``team_tpu/learners/proof_net.py``).

* Per-task growth (projections, context prompts, prototypes) lives in
  preallocated banks with masks, as in the reference port.
* The frozen towers are outside the step: it consumes cached image features.
* The classification logits carry no gradient in parity mode (the reference
  computes them under ``no_grad``).
* Gradients reach only the newest task's projection and prompt slices, and
  the frozen slices are restored after each update so that weight decay
  cannot move them.

``trainable`` is a dict of leaf tensors (``requires_grad``), ``aux`` the
frozen temporal GCN and lifecycle detector; both keep the JAX pytree's keys
and layouts, so :mod:`team_tpu_torch.bridge` carries them across. The step
runs eagerly, one batch at a time; the dropout keeps come from an explicit
``torch.Generator`` or from the caller.

Under a data-parallel group (:class:`DataShard`) each rank holds its rows of
the global batch, and the step computes team_tpu's one global step: the
terms that compare rows across the batch (CLIP, UniCL) run on the gathered
rows with this rank's rows live and the others detached, the per-row CE is a
masked sum over the global valid count, ``logit_scale`` (the only parameter
the CLIP term uses directly) is live on rank 0 alone, and the ranks'
gradients are summed, not averaged. The usual DDP recipe (every rank's
gathered loss, gradients averaged) would be off by the world size.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from team_tpu_torch.losses.clip_loss import clip_loss
from team_tpu_torch.losses.unicl import unicl_loss
from team_tpu_torch.modules.fusion import KeepMasks, fusion_attention, init_fusion
from team_tpu_torch.modules.lifecycle import init_evolution_detector
from team_tpu_torch.modules.projections import apply_projection_bank, init_projection_bank
from team_tpu_torch.modules.temporal_gcn import init_temporal_gcn
from team_tpu_torch.parallel import collectives

NEG_INF = -1e30
PROJECTIONS = ("proj_img", "proj_text", "proj_state")


@dataclasses.dataclass(frozen=True)
class ProofDims:
    feature_dim: int
    max_classes: int
    max_tasks: int
    num_states: int = 10
    ctx_len: int = 10          # context_prompt_length_per_task
    gcn_layers: int = 2
    gcn_hidden_dim: int = 0    # 0 -> the reference's feature_dim // 2

    @property
    def gcn_hidden(self) -> int:
        return self.gcn_hidden_dim or self.feature_dim // 2


class TaskContext(NamedTuple):
    """Per-task constants of the step."""

    task_mask: torch.Tensor         # [T] tasks created so far
    cur_onehot: torch.Tensor        # [T] newest task
    class_mask: torch.Tensor        # [C] classes seen so far
    class_text_basic: torch.Tensor  # [C, D] frozen-tower features of the class prompts


class ProofBuffers(NamedTuple):
    """State evolved by the temporal stack (no gradient)."""

    img_prototypes: torch.Tensor        # [C, D]
    proto_state: torch.Tensor           # [C, S, D]
    proto_mask: torch.Tensor            # [C, S]
    evolution_embeddings: torch.Tensor  # [C, D]
    evolution_valid: torch.Tensor       # [C] bool
    lifecycle_types: torch.Tensor       # [C] int32


def init_buffers(dims: ProofDims, device=None) -> ProofBuffers:
    c, s, d = dims.max_classes, dims.num_states, dims.feature_dim
    return ProofBuffers(
        img_prototypes=torch.zeros((c, d), device=device),
        proto_state=torch.zeros((c, s, d), device=device),
        proto_mask=torch.zeros((c, s), device=device),
        evolution_embeddings=torch.zeros((c, d), device=device),
        evolution_valid=torch.zeros((c,), dtype=torch.bool, device=device),
        lifecycle_types=torch.full((c,), 3, dtype=torch.int32, device=device),  # UNKNOWN
    )


def init_proof_params(gen: torch.Generator, dims: ProofDims, logit_scale_init: float
                      ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(trainable, aux) on the CPU, with the distributions of the JAX init;
    the bits differ, since torch and JAX draw differently. ``logit_scale`` is
    the only tower parameter that trains."""
    d, h = dims.feature_dim, dims.gcn_hidden
    trainable = {
        "proj_img": init_projection_bank(gen, dims.max_tasks, d),
        "proj_text": init_projection_bank(gen, dims.max_tasks, d),
        "proj_state": init_projection_bank(gen, dims.max_tasks, d),
        "sel_attn": init_fusion(gen, 1, d, d, d),
        "context_prompts": torch.randn((dims.max_tasks, dims.ctx_len, d), generator=gen),
        "state_embed": torch.randn((dims.num_states, d), generator=gen),  # nn.Embedding: N(0, 1)
        "logit_scale": torch.tensor(logit_scale_init, dtype=torch.float32),
    }
    aux = {"temporal_gcn": init_temporal_gcn(gen, d, h, dims.gcn_layers),
           "evolution_detector": init_evolution_detector(gen, d, h)}
    return trainable, aux


def _normalize(x: torch.Tensor) -> torch.Tensor:
    # grad-safe at ||x|| = 0: zero-padded prototype rows carry gradients
    return x / torch.sqrt(torch.clamp((x * x).sum(dim=-1, keepdim=True), min=1e-24))


# ---------------------------------------------------------------------------
# functional forward pieces (the reference's Proof_Net methods)
# ---------------------------------------------------------------------------

def project_image(tr, basic: torch.Tensor, ctx: TaskContext, grad_current_only: bool = True):
    return apply_projection_bank(tr["proj_img"], basic, ctx.task_mask,
                                 ctx.cur_onehot if grad_current_only else None)


def project_text(tr, basic: torch.Tensor, ctx: TaskContext, grad_current_only: bool = True):
    return apply_projection_bank(tr["proj_text"], basic, ctx.task_mask,
                                 ctx.cur_onehot if grad_current_only else None)


def encode_state(tr, state_ids: torch.Tensor, ctx: TaskContext, normalize: bool = True):
    feats = apply_projection_bank(tr["proj_state"], tr["state_embed"][state_ids.long()],
                                  ctx.task_mask, ctx.cur_onehot)
    return _normalize(feats) if normalize else feats


def encode_prototypes(tr, img_prototypes: torch.Tensor, ctx: TaskContext, normalize: bool = True):
    feats = apply_projection_bank(tr["proj_img"], img_prototypes, ctx.task_mask, ctx.cur_onehot)
    return _normalize(feats) if normalize else feats


def classification_logits(tr, basic_img: torch.Tensor, ctx: TaskContext) -> torch.Tensor:
    """Cosine logits of the projected image features against the projected
    class-prompt features, masked to the classes seen so far."""
    img = _normalize(project_image(tr, basic_img, ctx))
    txt = _normalize(project_text(tr, ctx.class_text_basic, ctx))
    logits = img @ txt.T
    return torch.where(ctx.class_mask[None, :] > 0, logits,
                       torch.full((), NEG_INF, dtype=logits.dtype, device=logits.device))


def _ctx_tokens(tr, ctx: TaskContext, freeze_old: bool) -> torch.Tensor:
    prompts = tr["context_prompts"]
    if freeze_old:  # the reference's update_context_prompt
        keep = ctx.cur_onehot[:, None, None]
        prompts = prompts.detach() * (1 - keep) + prompts * keep
    t, l, d = prompts.shape
    return prompts.reshape(t * l, d)


def tri_modal_forward(tr, basic_img: torch.Tensor, basic_txt: torch.Tensor,
                      state_ids: torch.Tensor, img_prototypes: torch.Tensor, ctx: TaskContext,
                      deterministic: bool = True, keep_masks: Optional[KeepMasks] = None,
                      generator: Optional[torch.Generator] = None,
                      keep_shard: Optional[Tuple[int, int]] = None):
    """Fuse [image, text, state, prototypes, context prompts] through the
    one-head attention and slice the per-modality outputs back out
    (``keep_shard``: see :func:`fusion_attention`)."""
    b, d = basic_img.shape
    img = _normalize(project_image(tr, basic_img, ctx))
    txt = _normalize(project_text(tr, basic_txt, ctx))
    st = encode_state(tr, state_ids, ctx, normalize=True)
    proto = encode_prototypes(tr, img_prototypes, ctx, normalize=True)  # [C, D]
    ctx_tokens = _ctx_tokens(tr, ctx, freeze_old=True)
    c = proto.shape[0]
    l = tr["context_prompts"].shape[1]
    seq = torch.cat([img[:, None], txt[:, None], st[:, None], proto[None].expand(b, c, d),
                     ctx_tokens[None].expand(b, -1, d)], dim=1)
    key_mask = torch.cat([torch.ones(3, device=img.device), ctx.class_mask,
                          ctx.task_mask.repeat_interleave(l)])
    out = fusion_attention(tr["sel_attn"], seq, key_mask, deterministic=deterministic,
                           keep_masks=keep_masks, generator=generator, keep_shard=keep_shard)
    cmask = ctx.class_mask[None, :, None]
    proto_f = (out[:, 3:3 + c] * cmask).sum(dim=1) / torch.clamp(cmask.sum(dim=1), min=1.0)
    return out[:, 0], out[:, 1], out[:, 2], proto_f, torch.exp(tr["logit_scale"])


def bi_modal_forward(tr, basic_img: torch.Tensor, basic_txt: torch.Tensor,
                     img_prototypes: torch.Tensor, ctx: TaskContext, deterministic: bool = True,
                     keep_masks: Optional[KeepMasks] = None,
                     generator: Optional[torch.Generator] = None):
    """The reference's ``Proof_Net.forward``: fuse [image, batch texts,
    prototypes, context prompts] (no state token) and average the text and
    prototype outputs over the batch."""
    b, d = basic_img.shape
    img = _normalize(project_image(tr, basic_img, ctx))
    txt = _normalize(project_text(tr, basic_txt, ctx))
    proto = encode_prototypes(tr, img_prototypes, ctx, normalize=True)
    ctx_tokens = _ctx_tokens(tr, ctx, freeze_old=False)
    n_txt, c = txt.shape[0], proto.shape[0]
    l = tr["context_prompts"].shape[1]
    seq = torch.cat([img[:, None], txt[None].expand(b, n_txt, d), proto[None].expand(b, c, d),
                     ctx_tokens[None].expand(b, -1, d)], dim=1)
    key_mask = torch.cat([torch.ones(1 + n_txt, device=img.device), ctx.class_mask,
                          ctx.task_mask.repeat_interleave(l)])
    out = fusion_attention(tr["sel_attn"], seq, key_mask, deterministic=deterministic,
                           keep_masks=keep_masks, generator=generator)
    txt_f = out[:, 1:1 + n_txt].mean(dim=0)
    proto_f = out[:, 1 + n_txt:1 + n_txt + c].mean(dim=0)
    return out[:, 0], txt_f, torch.exp(tr["logit_scale"]), proto_f


# ---------------------------------------------------------------------------
# loss and train step
# ---------------------------------------------------------------------------

class DataShard(NamedTuple):
    """This rank's place on the data axis: the axis's process group, this
    rank's index on it and its size."""

    group: Any
    rank: int
    size: int


class StepStats(NamedTuple):
    total_loss: torch.Tensor
    ce_loss: torch.Tensor
    clip_loss: torch.Tensor
    unicl_loss: torch.Tensor
    correct: torch.Tensor


def proof_loss(tr, batch: Dict[str, torch.Tensor], ctx: TaskContext, buffers: ProofBuffers,
               epoch: int, *, max_epoch: int, temperature: float, instance_weight: float,
               category_weight: float, unicl_weight: float, num_states: int,
               parity_no_grad_ce: bool, clip_shards: int = 1, data: Optional[DataShard] = None,
               keep_masks: Optional[KeepMasks] = None,
               generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, StepStats]:
    """CE + CLIP + ``unicl_weight``·UniCL over a batch of cached features.
    ``batch``: ``feat [B, D]``, ``label [B]``, ``stage_id [B]`` and, for a
    padded batch, ``valid_mask [B]`` (1 = real row), which every term honours.

    ``clip_shards > 1`` (fix mode's ``global_clip_loss=False``): the CLIP
    term per shard of the batch, weighted by the shards' valid counts.
    ``data``: the batch is this rank's rows of the global batch
    (module docstring); the returned loss is this rank's share for backward
    and the stats are this rank's parts, whose sum over the group is the
    global step's stats (:func:`train_step` sums them)."""
    basic_img, targets, state_ids = batch["feat"], batch["label"].long(), batch["stage_id"].long()
    vm = batch.get("valid_mask")
    basic_txt = ctx.class_text_basic[targets]

    # 1) classification branch (no gradient in the reference)
    logits = classification_logits(tr, basic_img, ctx)
    if parity_no_grad_ce:
        logits = logits.detach()
    per_row_ce = -F.log_softmax(logits, dim=-1).gather(1, targets[:, None])[:, 0]

    # 2) tri-modal fusion, 3) CLIP loss on the projected features before it
    sharded = data is not None and data.size > 1
    img_f, txt_f, st_f, _, logit_scale = tri_modal_forward(
        tr, basic_img, basic_txt, state_ids, buffers.img_prototypes, ctx, deterministic=False,
        keep_masks=keep_masks, generator=generator,
        keep_shard=(data.rank, data.size) if sharded else None)
    img_norm = _normalize(project_image(tr, basic_img, ctx))
    txt_norm = _normalize(project_text(tr, basic_txt, ctx))
    unicl_kw = dict(temperature=temperature, epoch=epoch, max_epoch=max_epoch,
                    evolution_embeddings=buffers.evolution_embeddings,
                    evolution_valid=buffers.evolution_valid, num_states=num_states,
                    instance_weight=instance_weight, category_weight=category_weight)
    hits = logits.argmax(dim=1) == targets
    if vm is not None:
        hits = hits & (vm > 0)
    if sharded:
        return _data_parallel_terms(data, per_row_ce, img_norm, txt_norm, img_f, txt_f, st_f,
                                    targets, state_ids, vm, logit_scale, hits, clip_shards,
                                    unicl_weight, unicl_kw)

    ce = per_row_ce.mean() if vm is None else (per_row_ce * vm).sum() / torch.clamp(vm.sum(), min=1.0)
    if clip_shards > 1:
        d = img_norm.shape[-1]
        vm_s = (torch.ones(img_norm.shape[0], device=img_norm.device) if vm is None
                else vm).reshape(clip_shards, -1)
        shard_losses = torch.stack([
            clip_loss(a, t, logit_scale, valid_mask=v) for a, t, v in zip(
                img_norm.reshape(clip_shards, -1, d), txt_norm.reshape(clip_shards, -1, d), vm_s)])
        # a pure-padding shard returns 0 and carries zero weight
        counts = vm_s.sum(dim=1)
        clip_val = (shard_losses * counts).sum() / torch.clamp(counts.sum(), min=1.0)
    else:
        clip_val = clip_loss(img_norm, txt_norm, logit_scale, valid_mask=vm)

    # 4) UniCL on the fused features
    unicl_val, _ = unicl_loss(img_f, txt_f, st_f, targets, state_ids, valid_mask=vm, **unicl_kw)

    total = ce + clip_val + unicl_weight * unicl_val
    return total, StepStats(total, ce, clip_val, unicl_val, hits.sum())


def _data_parallel_terms(data: DataShard, per_row_ce, img_norm, txt_norm, img_f, txt_f, st_f,
                         targets, state_ids, vm, logit_scale, hits, clip_shards: int,
                         unicl_weight: float, unicl_kw: dict):
    """The global step's terms on this rank's rows (module docstring): one
    ``all_gather`` of the rows' features, labels, stage ids and validity."""
    b, d = img_norm.shape
    vm = torch.ones(b, device=img_norm.device) if vm is None else vm.float()
    rows = torch.cat([img_norm, txt_norm, img_f, txt_f, st_f, targets[:, None].float(),
                      state_ids[:, None].float(), vm[:, None]], dim=1)
    g = collectives.gather_rows(rows, data.group)
    g_img, g_txt, g_img_f, g_txt_f, g_st = g[:, :5 * d].split(d, dim=1)
    g_labels, g_states, g_vm = (g[:, 5 * d].detach().long(), g[:, 5 * d + 1].detach().long(),
                                g[:, 5 * d + 2].detach())
    n_valid = torch.clamp(g_vm.sum(), min=1.0)
    ce = (per_row_ce * vm).sum() / n_valid  # this rank's part of the global mean
    if clip_shards > 1:
        if clip_shards != data.size:
            raise ValueError(f"clip_shards={clip_shards} under {data.size} data ranks")
        # this rank's shard, weighted by its valid count (additive over ranks)
        clip_term = clip_loss(img_norm, txt_norm, logit_scale, valid_mask=vm) * vm.sum() / n_valid
        clip_part = clip_term.detach()
    else:
        ls = logit_scale if data.rank == 0 else logit_scale.detach()
        clip_term = clip_loss(g_img, g_txt, ls, valid_mask=g_vm)
        clip_part = clip_term.detach() / data.size
    unicl_val, _ = unicl_loss(g_img_f, g_txt_f, g_st, g_labels, g_states, valid_mask=g_vm,
                              **unicl_kw)
    loss = ce + clip_term + unicl_weight * unicl_val
    unicl_part = unicl_val.detach() / data.size
    ce_part = ce.detach()
    total_part = ce_part + clip_part + unicl_weight * unicl_part
    return loss, StepStats(total_part, ce_part, clip_part, unicl_part, hits.sum())


def loss_kwargs(cfg, dims: ProofDims, clip_shards: int = 1) -> dict:
    """The loss's constants from the config (parity mode keeps the
    reference's hard-coded temperature and UniCL weights); ``clip_shards``
    is the learner's (``proof.py:145-149``)."""
    parity = bool(cfg.parity_mode)
    return dict(
        max_epoch=cfg.tuned_epoch,
        temperature=0.07 if parity else float(cfg.temperature),
        instance_weight=1.0 if parity else float(cfg.unicl_instance_weight),
        category_weight=0.5 if parity else float(cfg.unicl_category_weight),
        unicl_weight=float(cfg.unicl_loss_weight),
        num_states=dims.num_states,
        parity_no_grad_ce=parity,
        clip_shards=int(clip_shards),
    )


def make_optimizer(cfg, params) -> torch.optim.Optimizer:
    """The per-task optimizer: optax ``adamw`` is ``torch.optim.AdamW``
    (decoupled decay); ``add_decayed_weights`` + ``sgd`` is ``torch.optim.SGD``
    with ``weight_decay`` (coupled, added to the gradient before momentum)."""
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.init_lr, momentum=cfg.momentum,
                               weight_decay=cfg.weight_decay)
    return torch.optim.AdamW(params, lr=cfg.init_lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def cosine_lr(cfg, epoch: int) -> float:
    """CosineAnnealingLR stepped per epoch, T_max = tuned_epoch, eta_min = min_lr."""
    t = min(epoch, cfg.tuned_epoch)
    return cfg.min_lr + 0.5 * (cfg.init_lr - cfg.min_lr) * (
        1.0 + math.cos(math.pi * t / cfg.tuned_epoch))


def lr_schedule(cfg, epoch: int) -> float:
    """Per-epoch learning rate. Parity mode keeps the reference's cosine;
    fix mode honours ``lr_scheduler`` (``cosine``, ``steplr``/``multisteplr``
    with ``milestones`` and ``gamma``, ``constant``)."""
    sched = "cosine" if cfg.parity_mode else str(cfg.lr_scheduler).lower()
    if sched in ("steplr", "multisteplr", "step", "multi_step", "multistep"):
        return float(cfg.init_lr * cfg.gamma ** sum(1 for m in cfg.milestones if epoch >= m))
    if sched == "constant":
        return float(cfg.init_lr)
    return cosine_lr(cfg, epoch)


def trainable_leaves(tr) -> list:
    """Every tensor of ``trainable``, in a fixed order."""
    out = []

    def walk(t):
        if isinstance(t, dict):
            for key in sorted(t):
                walk(t[key])
        else:
            out.append(t)

    walk(tr)
    return out


def _frozen_slices(tr) -> Dict[str, torch.Tensor]:
    return {**{f"{n}.{k}": tr[n][k] for n in PROJECTIONS for k in ("w", "b")},
            "context_prompts": tr["context_prompts"]}


@torch.no_grad()
def restore_frozen_slices(tr, old: Dict[str, torch.Tensor], cur_onehot: torch.Tensor) -> None:
    """Undo the optimizer's drift (weight decay) on the frozen per-task
    slices, in place: ``old`` holds copies taken before the update."""
    keep = cur_onehot.bool()
    for name, param in _frozen_slices(tr).items():
        param[~keep] = old[name][~keep]


def train_step(tr, opt: torch.optim.Optimizer, batch: Dict[str, torch.Tensor], ctx: TaskContext,
               buffers: ProofBuffers, epoch: int, kwargs: dict,
               keep_masks: Optional[KeepMasks] = None,
               generator: Optional[torch.Generator] = None,
               data: Optional[DataShard] = None) -> StepStats:
    """One optimizer step on ``tr`` (in place); returns the batch's stats.
    Under ``data`` the batch is this rank's rows: the ranks' gradients and
    stats are summed in one ``all_reduce`` before the update, so every rank
    takes the same step."""
    old = {name: t.detach().clone() for name, t in _frozen_slices(tr).items()}
    opt.zero_grad(set_to_none=False)
    loss, stats = proof_loss(tr, batch, ctx, buffers, epoch, keep_masks=keep_masks,
                             generator=generator, data=data, **kwargs)
    loss.backward()
    if data is not None and data.size > 1:
        stats = _sum_over_ranks(trainable_leaves(tr), stats, data)
    opt.step()
    restore_frozen_slices(tr, old, ctx.cur_onehot)
    return StepStats(*(t.detach() for t in stats))


def _sum_over_ranks(leaves, stats: StepStats, data: DataShard) -> StepStats:
    """Sum every leaf's gradient and the stats' parts over the data group in
    one ``all_reduce``. A leaf no rank reached keeps no gradient, as in a
    single-process step (the optimizer then skips it)."""
    has = [p.grad is not None for p in leaves]
    ref = stats.total_loss
    flat = torch.cat([torch.tensor(has, dtype=torch.float32, device=ref.device),
                      torch.stack([t.float() for t in stats])]
                     + [(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float()
                        for p in leaves])
    flat = collectives.all_reduce(flat, "sum", data.group)
    n = len(leaves)
    off = n + len(stats)
    for p, flag in zip(leaves, flat[:n].tolist()):
        if flag > 0:
            p.grad = flat[off:off + p.numel()].reshape(p.shape).to(p.dtype)
        else:
            p.grad = None
        off += p.numel()
    summed = flat[n:n + len(stats)]
    return StepStats(*(summed[i].to(t.dtype) for i, t in enumerate(stats)))


@torch.no_grad()
def eval_logits(tr, basic_img: torch.Tensor, ctx: TaskContext) -> torch.Tensor:
    """Classification logits for evaluation (no dropout, no gradient)."""
    return classification_logits(tr, basic_img, ctx)


@torch.no_grad()
def eval_correct_scan(tr, feats: torch.Tensor, labels: torch.Tensor, ctx: TaskContext) -> torch.Tensor:
    """Correct top-1 predictions over stacked batches ``[K, B, D]`` / ``[K, B]``."""
    logits = classification_logits(tr, feats.reshape(-1, feats.shape[-1]), ctx)
    return (logits.argmax(dim=1) == labels.reshape(-1).long()).sum()
