"""The port's PROOF learner against team_tpu.

Each module is fed the same numpy inputs (and the same parameters, carried
across by the bridge) as its JAX counterpart: the projection banks, the
fusion attention (with the dropout keeps drawn by ``jax.random`` and handed
to both), the CLIP and UniCL losses, the temporal GCN, the evolution pass,
the state-distance matrix and the lifecycle paths; then ``proof_loss`` with
its gradients and five AdamW (and SGD) steps. float32 throughout; the sums
run in another order, so values agree to 1e-5 relative (gradients, which pass
through the fusion softmax and the UniCL exponentials, to 1e-4 relative with
1e-6 absolute).

The gate: the 3-task protocol of tests/golden_protocol.py run through
``team_tpu_torch`` from the JAX init, with the dropout keeps the JAX learner
draws, reproduces tests/golden_protocol.json (curves within 0.1 pp, the loss
components of each epoch within 1e-3 relative, the tolerances of
tests/test_golden_protocol.py).
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from team_tpu.backbone.clip import CLIPConfig, init_clip_params
from team_tpu.learners import proof_net as jpn
from team_tpu.learners.proof import _pow2_chunks
from team_tpu.losses.clip_loss import clip_loss as jclip_loss
from team_tpu.losses.unicl import unicl_loss as junicl_loss
from team_tpu.modules import evolution as jevo
from team_tpu.modules import fusion as jfusion
from team_tpu.modules import lifecycle as jlife
from team_tpu.modules import projections as jproj
from team_tpu.modules import state_distance as jsd
from team_tpu.modules import temporal_gcn as jgcn
from team_tpu_torch.bridge import params_from_numpy, proof_state_from_numpy, proof_state_to_numpy
from team_tpu_torch.config import Config
from team_tpu_torch.data import DataManager
from team_tpu_torch.learners import proof_net as tpn
from team_tpu_torch.learners.factory import get_model
from team_tpu_torch.losses import clip_loss as tclip
from team_tpu_torch.losses import unicl as tunicl
from team_tpu_torch.modules import evolution as tevo
from team_tpu_torch.modules import fusion as tfusion
from team_tpu_torch.modules import lifecycle as tlife
from team_tpu_torch.modules import projections as tproj
from team_tpu_torch.modules import state_distance as tsd
from team_tpu_torch.modules import temporal_gcn as tgcn

GOLDEN = Path(__file__).resolve().parent / "golden_protocol.json"
RTOL, ATOL = 1e-5, 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return params_from_numpy(_np(tree))


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def _dims(d=16, c=6, t=3, s=10, l=3):
    return jpn.ProofDims(feature_dim=d, max_classes=c, max_tasks=t, num_states=s, ctx_len=l)


def _ctx(dims, cur_task, n_classes, rng):
    tm = np.zeros(dims.max_tasks, np.float32)
    tm[: cur_task + 1] = 1
    cur = np.zeros(dims.max_tasks, np.float32)
    cur[cur_task] = 1
    cm = np.zeros(dims.max_classes, np.float32)
    cm[:n_classes] = 1
    text = np.zeros((dims.max_classes, dims.feature_dim), np.float32)
    text[:n_classes] = rng.standard_normal((n_classes, dims.feature_dim))
    return (jpn.TaskContext(*map(jnp.asarray, (tm, cur, cm, text))),
            tpn.TaskContext(*map(torch.from_numpy, (tm, cur, cm, text))))


def _fusion_len(dims):
    """Tokens of the tri-modal fusion sequence (image, text, state, class
    prototypes, context prompts)."""
    return 3 + dims.max_classes + dims.max_tasks * dims.ctx_len


def _fusion_keeps(key, b, s, d, rate=0.1):
    """The keeps fusion_attention draws from ``key`` (fusion.py:83-89)."""
    r1, r2 = jax.random.split(key)
    return (np.array(jax.random.bernoulli(r1, 1.0 - rate, (b, 1, s, s))),
            np.array(jax.random.bernoulli(r2, 1.0 - rate, (b, s, d))))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_projection_bank_matches_jax():
    rng = np.random.default_rng(0)
    bank = jproj.init_projection_bank(jax.random.PRNGKey(1), 3, 16)
    x = rng.standard_normal((5, 16)).astype(np.float32)
    tm, cur = np.array([1, 1, 0], np.float32), np.array([0, 1, 0], np.float32)
    for onehot in (None, cur):
        want = jproj.apply_projection_bank(bank, jnp.asarray(x), jnp.asarray(tm),
                                           None if onehot is None else jnp.asarray(onehot))
        got = tproj.apply_projection_bank(_t(bank), torch.from_numpy(x), torch.from_numpy(tm),
                                          None if onehot is None else torch.from_numpy(onehot))
        _close(got, want)
    # gradients reach only the current task's slice
    tb = {k: v.requires_grad_() for k, v in _t(bank).items()}
    tproj.apply_projection_bank(tb, torch.from_numpy(x), torch.from_numpy(tm),
                                torch.from_numpy(cur)).sum().backward()
    assert tb["w"].grad[0].abs().max() == 0 and tb["w"].grad[2].abs().max() == 0
    assert tb["w"].grad[1].abs().max() > 0
    gen = torch.Generator().manual_seed(0)
    init = tproj.init_projection_bank(gen, 3, 16)
    assert init["w"].shape == (3, 16, 16) and float(init["w"].abs().max()) <= 0.25


@pytest.mark.parametrize("deterministic", [True, False], ids=["eval", "train"])
def test_fusion_attention_matches_jax(deterministic):
    rng = np.random.default_rng(1)
    b, s, d = 4, 9, 16
    params = jfusion.init_fusion(jax.random.PRNGKey(2), 1, d, d, d)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    km = np.array([1, 1, 1, 1, 0, 1, 0, 0, 1], np.float32)
    key = jax.random.PRNGKey(3)
    want = jfusion.fusion_attention(params, jnp.asarray(x), jnp.asarray(km), rng=key,
                                    deterministic=deterministic)
    keeps = None if deterministic else tuple(map(torch.from_numpy, _fusion_keeps(key, b, s, d)))
    got = tfusion.fusion_attention(_t(params), torch.from_numpy(x), torch.from_numpy(km),
                                   deterministic=deterministic, keep_masks=keeps)
    _close(got, want)


def test_fusion_dropout_draws_from_the_generator():
    params = tfusion.init_fusion(torch.Generator().manual_seed(0), 1, 8, 8, 8)
    x = torch.randn((2, 5, 8), generator=torch.Generator().manual_seed(1))
    km = torch.ones(5)

    def run(seed):
        return tfusion.fusion_attention(params, x, km, deterministic=False,
                                        generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))


def test_clip_loss_matches_jax():
    rng = np.random.default_rng(2)
    img, txt = (rng.standard_normal((6, 16)).astype(np.float32) for _ in range(2))
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=1, keepdims=True)
    vm = np.array([1, 1, 1, 1, 0, 0], np.float32)
    for mask in (None, vm):
        want = jclip_loss(jnp.asarray(img), jnp.asarray(txt), jnp.asarray(14.3),
                               valid_mask=None if mask is None else jnp.asarray(mask))
        got = tclip.clip_loss(torch.from_numpy(img), torch.from_numpy(txt), torch.tensor(14.3),
                              valid_mask=None if mask is None else torch.from_numpy(mask))
        _close(got, want)
    # a padded batch's loss is the unpadded batch's
    _close(tclip.clip_loss(torch.from_numpy(img), torch.from_numpy(txt), torch.tensor(14.3),
                           valid_mask=torch.from_numpy(vm)),
           tclip.clip_loss(torch.from_numpy(img[:4]), torch.from_numpy(txt[:4]), torch.tensor(14.3)))
    # the global-batch form with no process group joined gathers over a world
    # of one: the single-shard loss (tests/test_torch_parallel.py holds it
    # against team_tpu's shard_map over two ranks)
    for mask in (None, vm):
        m = None if mask is None else torch.from_numpy(mask)
        _close(tclip.clip_loss(torch.from_numpy(img), torch.from_numpy(txt), torch.tensor(14.3),
                               axis_name="data", valid_mask=m),
               jclip_loss(jnp.asarray(img), jnp.asarray(txt), jnp.asarray(14.3),
                          valid_mask=None if mask is None else jnp.asarray(mask)))


@pytest.mark.parametrize("case", ["plain", "evolution", "padded"])
def test_unicl_loss_matches_jax(case):
    rng = np.random.default_rng(3)
    b, d, c, s = 8, 16, 4, 10
    img, txt, st = (rng.standard_normal((b, d)).astype(np.float32) for _ in range(3))
    labels = np.array([0, 0, 1, 1, 1, 2, 3, 3], np.int32)
    stages = np.array([1, 4, 3, 4, 4, 1, 2, 2], np.int32)
    evo = rng.standard_normal((c, d)).astype(np.float32)
    evo_valid = np.array([True, True, False, True])
    vm = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32) if case == "padded" else None
    use_evo = case != "plain"
    kw = dict(temperature=0.07, epoch=1, max_epoch=4, num_states=s)
    want, wparts = junicl_loss(
        *map(jnp.asarray, (img, txt, st, labels, stages)),
        evolution_embeddings=jnp.asarray(evo) if use_evo else None,
        evolution_valid=jnp.asarray(evo_valid) if use_evo else None,
        valid_mask=None if vm is None else jnp.asarray(vm), **kw)
    got, gparts = tunicl.unicl_loss(
        *map(torch.from_numpy, (img, txt, st, labels, stages)),
        evolution_embeddings=torch.from_numpy(evo) if use_evo else None,
        evolution_valid=torch.from_numpy(evo_valid) if use_evo else None,
        valid_mask=None if vm is None else torch.from_numpy(vm), **kw)
    _close(got, want)
    for k in ("instance_loss", "category_loss", "temperature"):
        _close(gparts[k], wparts[k], msg=k)


def test_unicl_quirks():
    # exp(0) = 1 in the positive sum: identical modalities still give a finite,
    # non-zero instance loss; the NaN guard falls back to the finite term
    x = torch.nn.functional.normalize(torch.randn(4, 8, generator=torch.Generator().manual_seed(0)), dim=1)
    labels = torch.tensor([0, 1, 2, 3])
    total, parts = tunicl.unicl_loss(x, x, x, labels, torch.zeros(4, dtype=torch.long))
    assert float(parts["category_loss"]) == 0.0  # no same-label partner anywhere
    assert torch.isfinite(total) and float(parts["instance_loss"]) > 0
    one, _ = tunicl.unicl_loss(x[:1], x[:1], x[:1], labels[:1], labels[:1])
    assert float(one) == 0.0


def test_temporal_gcn_matches_jax():
    rng = np.random.default_rng(4)
    n, d, h = 12, 16, 8
    params = jgcn.init_temporal_gcn(jax.random.PRNGKey(5), d, h, 2)
    x = rng.standard_normal((n, d)).astype(np.float32)
    adj = (rng.random((n, n)) * (rng.random((n, n)) < 0.3)).astype(np.float32)
    em = adj > 0
    em[0, 1] = True  # a zero-weight edge still counts in the mean
    t = rng.random((n, 1)).astype(np.float32)
    want = jax.jit(functools.partial(jgcn.temporal_gcn_forward, time_weight=0.5))(
        params, *map(jnp.asarray, (x, adj, t, em)))
    got = tgcn.temporal_gcn_forward(_t(params), *map(torch.from_numpy, (x, adj, t, em)),
                                    time_weight=0.5)
    _close(got, want)


def _proto_bank(rng, c=6, s=10, d=16):
    mask = np.zeros((c, s), np.float32)
    mask[0, [1, 2, 4]] = 1   # larva -> adult
    mask[1, [3, 4]] = 1      # nymph -> adult (a zero-weight first->last edge)
    mask[2, [1, 4]] = 1
    mask[3, [4]] = 1         # one state: does not take part
    mask[4, [0, 1, 2, 4]] = 1
    protos = rng.standard_normal((c, s, d)).astype(np.float32) * mask[:, :, None]
    return protos, mask, np.full((c,), 3, np.int32)


@pytest.mark.parametrize("fix", [False, True], ids=["parity", "fix"])
def test_evolution_matches_jax(fix):
    rng = np.random.default_rng(6)
    d = 16
    gcn = jgcn.init_temporal_gcn(jax.random.PRNGKey(7), d, d // 2, 2)
    protos, mask, types = _proto_bank(rng, d=d)
    kw = dict(intra_edge_threshold=0.2, inter_edge_weight=0.35, time_weight=0.25) if fix else {}
    want = jevo.evolve_and_update(gcn, *map(jnp.asarray, (protos, mask, types)), **kw)
    got = tevo.evolve_and_update(_t(gcn), *map(torch.from_numpy, (protos, mask, types)), **kw)
    for name in want._fields:
        w, g = getattr(want, name), getattr(got, name)
        if np.asarray(w).dtype == bool or np.asarray(w).dtype.kind == "i":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        else:
            _close(g, w, msg=name)
    np.testing.assert_array_equal(tevo.detect_lifecycle_types(torch.from_numpy(mask)).numpy(),
                                  np.asarray(jevo.detect_lifecycle_types(jnp.asarray(mask))))
    _close(tevo.state_time_steps(torch.from_numpy(mask)), jevo.state_time_steps(jnp.asarray(mask)))
    upd = np.ones_like(mask, dtype=bool)
    fused_w = jevo.fuse_evolved_prototypes(jnp.asarray(protos), want.prototypes, jnp.asarray(mask),
                                           jnp.asarray(upd), parity=not fix, alpha=0.6)
    fused_g = tevo.fuse_evolved_prototypes(torch.from_numpy(protos), got.prototypes,
                                           torch.from_numpy(mask), torch.from_numpy(upd),
                                           parity=not fix, alpha=0.6)
    _close(fused_g, fused_w)
    if not fix:  # the aliasing quirk: the fuse keeps the evolved features as they are
        _close(fused_g, got.prototypes, rtol=0, atol=0)
    img = rng.standard_normal((6, d)).astype(np.float32)
    _close(tevo.sync_class_prototypes(fused_g, torch.from_numpy(mask), torch.from_numpy(img), 1.5),
           jevo.sync_class_prototypes(fused_w, jnp.asarray(mask), jnp.asarray(img), 1.5))


def test_state_distance_matches_jax():
    rng = np.random.default_rng(8)
    s = 10
    jm = jsd.StateDistanceMatrix(num_states=s, update_interval=2)
    tm = tsd.StateDistanceMatrix(num_states=s, update_interval=2)
    for _ in range(3):
        dist = rng.random((s, s)).astype(np.float32)
        valid = rng.random((s, s)) < 0.5
        jm.merge_gcn_distances(jnp.asarray(dist), jnp.asarray(valid.astype(np.float32)), weight=0.3)
        tm.merge_gcn_distances(torch.from_numpy(dist), torch.from_numpy(valid))
    for _ in range(3):
        feats = rng.standard_normal((12, 16)).astype(np.float32)
        ids = rng.integers(0, s, 12).astype(np.int32)
        _close(tm.ema_update_from_batch(torch.from_numpy(feats), torch.from_numpy(ids)),
               jm.ema_update_from_batch(jnp.asarray(feats), jnp.asarray(ids)))
    _close(tm.distance_factors, jm.distance_factors)
    _close(tm.get_distance_matrix(), jm.get_distance_matrix())
    assert tm.get_state_distance(1, 4) == pytest.approx(jm.get_state_distance(1, 4), rel=1e-6)


def test_state_distance_history_holds_host_numbers():
    """Reference defect (state_distance.py:80): a device scalar kept per merge.
    The port records plain ints and keeps the matrix on the host."""
    sd = tsd.StateDistanceMatrix(num_states=10)
    valid = torch.zeros(10, 10, dtype=torch.bool)
    valid[1, 4] = valid[4, 1] = valid[2, 2] = True
    sd.merge_gcn_distances(torch.rand(10, 10), valid)
    sd.merge_gcn_distances(torch.rand(10, 10), valid)
    assert [h["changes"] for h in sd.update_history] == [3, 3]
    assert all(type(h["changes"]) is int for h in sd.update_history)
    assert sd.distance_factors.device.type == "cpu"


def test_lifecycle_matches_jax():
    rng = np.random.default_rng(9)
    d = 16
    proj = jlife.init_evolution_projectors(jax.random.PRNGKey(10), d)
    dm = rng.random((10, 10)).astype(np.float32) + 0.5
    want = jlife.integrate_with_state_distance(proj, jnp.asarray(dm), scale=0.4)
    got = tlife.integrate_with_state_distance(_t(proj), torch.from_numpy(dm), scale=0.4)
    for k in want:
        _close(got[k]["b"], want[k]["b"])
    feat = rng.standard_normal(d).astype(np.float32)
    wf, wa = jlife.evolution_trajectory(proj, 1, jnp.asarray(feat), num_steps=5)
    gf, ga = tlife.evolution_trajectory(_t(proj), 1, torch.from_numpy(feat), num_steps=5)
    _close(gf, wf)
    _close(ga, wa)
    assert tlife.evolution_trajectory(_t(proj), 2, torch.from_numpy(feat)) is None
    det = jlife.init_evolution_detector(jax.random.PRNGKey(11), d, 8)
    pair = rng.standard_normal((3, 2 * d)).astype(np.float32)
    _close(tlife.evolution_detector_forward(_t(det), torch.from_numpy(pair)),
           jlife.evolution_detector_forward(det, jnp.asarray(pair)))


# ---------------------------------------------------------------------------
# proof_loss, its gradients and the train step
# ---------------------------------------------------------------------------

def _loss_setup(rng, b=8, cur_task=1, n_classes=4):
    dims = _dims()
    jtr, _ = jpn.init_proof_params(jax.random.PRNGKey(12), dims, float(np.log(1 / 0.07)))
    jctx, tctx = _ctx(dims, cur_task, n_classes, rng)
    buffers = jpn.init_buffers(dims)._replace(
        img_prototypes=jnp.asarray(rng.standard_normal((6, 16)).astype(np.float32)),
        evolution_embeddings=jnp.asarray(rng.standard_normal((6, 16)).astype(np.float32)),
        evolution_valid=jnp.asarray(np.array([1, 1, 0, 1, 0, 0], bool)))
    tbuffers = tpn.ProofBuffers(**params_from_numpy(_np(buffers)))
    batch = {"feat": rng.standard_normal((b, 16)).astype(np.float32),
             "label": rng.integers(0, n_classes, b).astype(np.int32),
             "stage_id": rng.integers(0, 10, b).astype(np.int32),
             "valid_mask": np.array([1] * (b - 2) + [0, 0], np.float32)}
    return dims, jtr, jctx, tctx, buffers, tbuffers, batch


class _Cfg:
    parity_mode = True
    tuned_epoch = 4
    temperature = 0.07
    unicl_instance_weight = 1.0
    unicl_category_weight = 0.5
    unicl_loss_weight = 0.3
    optimizer = "adam"
    init_lr = 0.01
    min_lr = 0.0
    weight_decay = 5e-2
    momentum = 0.9
    lr_scheduler = "cosine"
    milestones = (2, 3)
    gamma = 0.5

    def get(self, name, default=None):
        return getattr(self, name, default)


@pytest.mark.parametrize("parity", [True, False], ids=["parity", "fix"])
def test_proof_loss_and_grads_match_jax(parity):
    rng = np.random.default_rng(13)
    dims, jtr, jctx, tctx, jbuf, tbuf, batch = _loss_setup(rng)
    key = jax.random.PRNGKey(14)
    cfg = _Cfg()
    cfg.parity_mode = parity
    jkw = jpn._loss_kwargs(cfg, dims, None, 1)
    tkw = tpn.loss_kwargs(cfg, dims)
    loss_and_grad = jax.jit(jax.value_and_grad(functools.partial(jpn.proof_loss, **jkw),
                                               has_aux=True))
    (wl, ws), wg = loss_and_grad(jtr, {k: jnp.asarray(v) for k, v in batch.items()}, jctx, jbuf,
                                 key, jnp.asarray(1))
    ttr = _t(jtr)
    for leaf in tpn.trainable_leaves(ttr):
        leaf.requires_grad_(True)
    keeps = tuple(map(torch.from_numpy, _fusion_keeps(key, 8, _fusion_len(dims), 16)))
    gl, gs = tpn.proof_loss(ttr, {k: torch.from_numpy(v) for k, v in batch.items()}, tctx, tbuf, 1,
                            keep_masks=keeps, **tkw)
    gl.backward()
    for name in ("total_loss", "ce_loss", "clip_loss", "unicl_loss", "correct"):
        _close(getattr(gs, name).detach(), getattr(ws, name), msg=name)
    flat_w = jax.tree_util.tree_flatten_with_path(wg)[0]
    for path, gw in flat_w:
        node = ttr
        for p in path:
            node = node[p.key]
        _close(node.grad, gw, rtol=1e-4, atol=1e-6, msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_train_steps_match_jax(optimizer):
    """Five optimizer steps against the JAX step (optax adamw / sgd), with the
    frozen slices restored after each."""
    rng = np.random.default_rng(15)
    dims, jtr, jctx, tctx, jbuf, tbuf, batch = _loss_setup(rng)
    cfg = _Cfg()
    cfg.optimizer = optimizer
    tx = jpn.make_optimizer(cfg)
    jstep = jpn.build_train_step(cfg, dims, tx)
    opt_state = tx.init(jtr)
    ttr = _t(jtr)
    for leaf in tpn.trainable_leaves(ttr):
        leaf.requires_grad_(True)
    opt = tpn.make_optimizer(cfg, tpn.trainable_leaves(ttr))
    tkw = tpn.loss_kwargs(cfg, dims)
    frozen_before = ttr["proj_img"]["w"][0].detach().clone()
    for i in range(5):
        key = jax.random.PRNGKey(100 + i)
        batch["feat"] = rng.standard_normal((8, 16)).astype(np.float32)
        jtr, opt_state, ws = jstep(jtr, opt_state, {k: jnp.asarray(v) for k, v in batch.items()},
                                   jctx, jbuf, key, jnp.asarray(i))
        keeps = tuple(map(torch.from_numpy, _fusion_keeps(key, 8, _fusion_len(dims), 16)))
        gs = tpn.train_step(ttr, opt, {k: torch.from_numpy(v) for k, v in batch.items()}, tctx,
                            tbuf, i, tkw, keep_masks=keeps)
        _close(gs.total_loss, ws.total_loss, rtol=1e-5, msg=f"step {i}")
    for path, w in jax.tree_util.tree_flatten_with_path(jtr)[0]:
        node = ttr
        for p in path:
            node = node[p.key]
        _close(node.detach(), w, rtol=1e-5, atol=2e-6, msg=jax.tree_util.keystr(path))
    assert torch.equal(ttr["proj_img"]["w"][0], frozen_before)  # task 0 is frozen


def test_lr_schedule_matches_jax():
    cfg = _Cfg()
    for parity in (True, False):
        cfg.parity_mode = parity
        for sched in ("cosine", "steplr", "constant"):
            cfg.lr_scheduler = sched
            for epoch in range(5):
                assert tpn.lr_schedule(cfg, epoch) == pytest.approx(jpn.lr_schedule(cfg, epoch),
                                                                    rel=1e-12)


def test_eval_logits_and_correct_match_jax():
    rng = np.random.default_rng(16)
    dims, jtr, jctx, tctx, *_ = _loss_setup(rng)
    feats = rng.standard_normal((3, 8, 16)).astype(np.float32)
    labels = rng.integers(0, 4, (3, 8)).astype(np.int32)
    ttr = _t(jtr)
    _close(tpn.eval_logits(ttr, torch.from_numpy(feats[0]), tctx),
           jpn.eval_logits(jtr, jnp.asarray(feats[0]), jctx))
    assert int(tpn.eval_correct_scan(ttr, torch.from_numpy(feats), torch.from_numpy(labels), tctx)) \
        == int(jpn.eval_correct_scan(jtr, jnp.asarray(feats), jnp.asarray(labels), jctx))
    wi, wt, ws, wl = jax.jit(jpn.bi_modal_forward)(jtr, jnp.asarray(feats[0]),
                                                   jnp.asarray(feats[1][:5]),
                                                   jnp.asarray(feats[2][:6]), jctx)
    gi, gt, gs, gp = tpn.bi_modal_forward(ttr, torch.from_numpy(feats[0]),
                                          torch.from_numpy(feats[1][:5]),
                                          torch.from_numpy(feats[2][:6]), tctx)
    for g, w in ((gi, wi), (gt, wt), (gs, ws), (gp, wl)):
        _close(g.detach(), w)


def test_bridge_carries_proof_state_bit_for_bit():
    dims = _dims()
    (tr, aux), buffers = jpn.init_proof_params(jax.random.PRNGKey(17), dims, 2.5), jpn.init_buffers(dims)
    state = {"trainable": _np(tr), "aux": _np(aux), "buffers": _np(buffers)._asdict()}
    ttr, taux, tbuf = proof_state_from_numpy(state)
    assert isinstance(tbuf, tpn.ProofBuffers) and tbuf.evolution_valid.dtype == torch.bool
    assert tbuf.lifecycle_types.dtype == torch.int32
    back = proof_state_to_numpy(ttr, taux, tbuf)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(state)[0],
                                 jax.tree_util.tree_flatten_with_path(back)[0]):
        assert a.dtype == b.dtype and np.array_equal(a, b), jax.tree_util.keystr(path)


# ---------------------------------------------------------------------------
# the learner end to end: the golden protocol gate
# ---------------------------------------------------------------------------

GOLDEN_KW = dict(
    prefix="golden", dataset="synthetic_insects", model_name="proof", convnet_type="clip",
    init_cls=2, increment=2, memory_size=12, tuned_epoch=2, batch_size=8, init_lr=0.01,
    optimizer="adam", context_prompt_length_per_task=3, seed=[7], shuffle=True,
    extras={"tiny_backbone": True, "dataset_kwargs": {"num_classes": 6, "img_size": 32}})


class JaxKeeps:
    """The fusion dropout keeps of the JAX learner (proof.py:65, 117, 430-431):
    its key is split once for the init, then once per power-of-two chunk of
    an epoch's batches, and each chunk's key into one key per batch."""

    def __init__(self, rng, batch, seq, d):
        self.rng, self.shape = rng, (batch, seq, d)
        self.epoch_keys = []

    def __call__(self, task, epoch, kb, n_batches):
        if kb == 0:
            self.epoch_keys = []
            for chunk in _pow2_chunks(n_batches):
                self.rng, sub = jax.random.split(self.rng)
                self.epoch_keys.extend(jax.random.split(sub, chunk))
        return _fusion_keeps(self.epoch_keys[kb], *self.shape)


def _jax_golden_init(cfg_kw):
    """The JAX learner's initial state for the golden config (proof.py:101-127)."""
    clip = init_clip_params(jax.random.PRNGKey(0), CLIPConfig.tiny())
    dims = jpn.ProofDims(feature_dim=32, max_classes=6, max_tasks=3, num_states=10,
                         ctx_len=cfg_kw["context_prompt_length_per_task"])
    key, rng = jax.random.split(jax.random.PRNGKey(cfg_kw["seed"][0]))
    ls = float(clip["logit_scale"])
    (tr, aux), buffers = jax.jit(
        lambda k: (jpn.init_proof_params(k, dims, ls), jpn.init_buffers(dims)))(key)
    state = {"trainable": _np(tr), "aux": _np(aux), "buffers": _np(buffers)}
    return params_from_numpy(_np(clip)), state, rng, dims


def run_port_golden(tmp_path):
    clip, state, rng, dims = _jax_golden_init(GOLDEN_KW)
    cfg = Config(**GOLDEN_KW, log_dir=str(tmp_path), device=["cpu"])
    dm = DataManager("synthetic_insects", shuffle=True, seed=7, init_cls=2, increment=2,
                     num_classes=6, img_size=32)
    model = get_model("proof", cfg, clip, proof_state=state)
    model._keep_masks_override = JaxKeeps(rng, cfg.batch_size, _fusion_len(dims), dims.feature_dim)
    stats = []
    model._epoch_stats_hook = lambda t, e, d: stats.append([t, e, {k: float(v) for k, v in d.items()}])
    curves = {"top1": [], "top4": [], "nme_top1": []}
    for _ in range(dm.nb_tasks):
        model.incremental_train(dm)
        cnn, nme, *_ = model.eval_task()
        model.after_task()
        model.update_state_distance_matrix(dm)
        curves["top1"].append(float(cnn["top1"]))
        curves["top4"].append(float(cnn["top4"]))
        curves["nme_top1"].append(float(nme["top1"]) if nme else None)
    return curves, stats


def test_golden_protocol_through_the_port(tmp_path):
    golden = json.loads(GOLDEN.read_text())
    curves, stats = run_port_golden(tmp_path)
    for key in ("top1", "top4", "nme_top1"):
        want, got = golden["curves"][key], curves[key]
        assert len(want) == len(got) == 3
        for t, (w, g) in enumerate(zip(want, got)):
            assert abs(w - g) <= 0.1, f"{key} task {t}: golden {w} vs port {g}"
    assert len(golden["stats"]) == len(stats) == 6
    for (t0, e0, d0), (t1, e1, d1) in zip(golden["stats"], stats):
        assert (t0, e0) == (t1, e1)
        assert d0["correct"] == d1["correct"] and d0["n"] == d1["n"]
        for k in ("total", "ce", "clip", "unicl"):
            assert abs(d0[k] - d1[k]) <= 1e-3 * max(1.0, abs(d0[k])), (
                f"task {t0} epoch {e0} {k}: golden {d0[k]} vs port {d1[k]}")


def test_an_epoch_without_batches_stacks_no_stats(tmp_path):
    """Reference defect (proof.py:444): an epoch's stats are stacked with
    ``jnp.stack``, which fails on an empty list. A task whose train set is
    empty trains no batch; the port reports zero losses for its epochs."""
    clip, state, _, _ = _jax_golden_init(GOLDEN_KW)
    cfg = Config(**GOLDEN_KW, log_dir=str(tmp_path), device=["cpu"])
    dm = DataManager("synthetic_insects", shuffle=True, seed=7, init_cls=2, increment=2,
                     num_classes=6, img_size=32)
    model = get_model("proof", cfg, clip, proof_state=state)
    model._cur_task, model._total_classes, model.data_manager = 0, 2, dm
    model._ensure_initialized(dm)
    model.ctx = model._make_ctx()
    rng = np.random.default_rng(18)
    model._train_feats = (np.zeros((0, 32), np.float32), np.zeros(0, np.int64), np.zeros(0, np.int64))
    model._test_feats = (rng.standard_normal((5, 32)).astype(np.float32), np.array([0, 1, 0, 1, 1]),
                         np.zeros(5, np.int64))
    model._train_stochastic = False
    stats = []
    model._epoch_stats_hook = lambda t, e, d: stats.append(d)
    before = [t.detach().clone() for t in tpn.trainable_leaves(model.trainable)]
    model._train_proj_with_replay()
    assert [d["n"] for d in stats] == [0, 0]
    assert all(d[k] == 0 for d in stats for k in ("total", "ce", "clip", "unicl", "correct"))
    assert all(torch.equal(a, b) for a, b in zip(before, tpn.trainable_leaves(model.trainable)))
