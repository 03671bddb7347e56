"""The port's data and tensor parallelism against team_tpu's, on the CPU.

One gloo world of two ranks is spawned for the module
(tests/torch_parallel_worker.py, ``file://`` rendezvous in a temporary
directory, no fixed port); each rank runs every case and pickles its
results, and the tests here hold them against team_tpu run in this process
on the conftest's virtual CPU devices:
- the global-batch and ``local_loss`` CLIP loss against team_tpu's under
  ``shard_map``, with padded rows (1e-5 relative);
- ``MeshContext.shard_batch`` (a batch smaller than the axis included) and
  the rank-shard index math against team_tpu's;
- a two-rank tensor-parallel encode, image and causal text, float32, against
  team_tpu's ``mha_packed_tp`` tower under ``shard_clip_params`` (the
  ``tp_check`` of tests/multihost_worker.py, its Pallas kernel in interpret
  mode; 1e-5);
- the int8 tier's calibration over two ranks (abs-maxes max-combined, one
  gate decision) and its q3i attention head-split, bit for bit the
  whole-head tower;
- a two-rank PROOF run of tests/test_dp_equality.py's configuration from the
  JAX init with team_tpu's dropout keeps: curves equal to the port's
  single-process run, parameters within atol 2e-5, rtol 2e-4 (that
  test's bounds), every step's summed gradients within 1e-4 of each leaf's
  largest, and against team_tpu's ``mesh_shape: [2]`` run at
  tests/test_torch_proof.py's protocol tolerances (curves 0.1 pp, loss
  components 1e-3 relative);
- no rank imports jax or team_tpu.
The head-split kernels' plain versions are held here too, in this process,
against team_tpu's under ``set_tp_mesh`` (interpret mode), at nm 2 and 4.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from team_tpu.backbone import clip as jclip
from team_tpu.config import Config as JConfig
from team_tpu.data.manager import DataManager as JDataManager
from team_tpu.learners import proof_net as jpn
from team_tpu.learners.factory import get_model as jget_model
from team_tpu.learners.proof import _pow2_chunks
from team_tpu.losses.clip_loss import clip_loss as jclip_loss
from team_tpu.ops import mha_short as jms
from team_tpu.parallel import mesh as jmesh
from team_tpu_torch.backbone import clip as tclip
from team_tpu_torch.backbone import quant as tquant
from team_tpu_torch.backbone.tokenizer import Tokenizer
from team_tpu_torch.bridge import params_from_numpy
from team_tpu_torch.config import Config
from team_tpu_torch.data import DataManager
from team_tpu_torch.learners import proof as tproof
from team_tpu_torch.learners.factory import get_model
from team_tpu_torch.learners.proof_net import trainable_leaves
from team_tpu_torch.ops import mha_short as tms
from team_tpu_torch.parallel import layout as tlayout
from team_tpu_torch.parallel import mesh as tmesh

WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
WORLD = 2
# tests/test_dp_equality.py:21-44: task sizes 30 and 42, so the last batch of
# every task is padded and masked
DP_CFG = dict(
    prefix="dpeq", dataset="synthetic_insects", model_name="proof", convnet_type="clip",
    init_cls=3, increment=3, memory_size=12, tuned_epoch=2, batch_size=16, init_lr=0.01,
    optimizer="adam", context_prompt_length_per_task=2, seed=[7], shuffle=True,
    extras={"tiny_backbone": True,
            "dataset_kwargs": {"num_classes": 6, "img_size": 32, "train_per_stage": 5,
                               "test_per_stage": 3}})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fusion_keeps(key, b, s, d, rate=0.1):
    """The keeps fusion_attention draws from ``key`` (team_tpu/modules/fusion.py)."""
    r1, r2 = jax.random.split(key)
    return (np.array(jax.random.bernoulli(r1, 1.0 - rate, (b, 1, s, s))),
            np.array(jax.random.bernoulli(r2, 1.0 - rate, (b, s, d))))


class JaxKeeps:
    """The JAX learner's fusion-dropout keeps for each batch (its key split
    once per power-of-two chunk of an epoch's batches, as in
    tests/test_torch_proof.py), recorded by (task, epoch, batch)."""

    def __init__(self, rng, batch, seq, d):
        self.rng, self.shape, self.epoch_keys, self.drawn = rng, (batch, seq, d), [], {}

    def __call__(self, task, epoch, kb, n_batches):
        if kb == 0:
            self.epoch_keys = []
            for chunk in _pow2_chunks(n_batches):
                self.rng, sub = jax.random.split(self.rng)
                self.epoch_keys.extend(jax.random.split(sub, chunk))
        keeps = _fusion_keeps(self.epoch_keys[kb], *self.shape)
        self.drawn[(task, epoch, kb)] = keeps
        return keeps


def _jax_init():
    """team_tpu's learner's initial state for DP_CFG (its CLIP init is
    PRNGKey(0), its PROOF init the first split of the seed's key)."""
    clip = jclip.init_clip_params(jax.random.PRNGKey(0), jclip.CLIPConfig.tiny())
    n_tasks = DP_CFG["extras"]["dataset_kwargs"]["num_classes"] // DP_CFG["increment"]
    dims = jpn.ProofDims(feature_dim=32, max_classes=6, max_tasks=n_tasks, num_states=10,
                         ctx_len=DP_CFG["context_prompt_length_per_task"])
    key, rng = jax.random.split(jax.random.PRNGKey(DP_CFG["seed"][0]))
    (tr, aux), buffers = jax.jit(lambda k: (jpn.init_proof_params(k, dims, float(clip["logit_scale"])),
                                            jpn.init_buffers(dims)))(key)
    # numpy leaves and plain containers only: the ranks unpickle them without jax
    state = {"trainable": _np(tr), "aux": _np(aux), "buffers": _np(buffers)._asdict()}
    return _np(clip), state, rng, 3 + dims.max_classes + dims.max_tasks * dims.ctx_len


def _run_protocol(model, dm):
    stats, curves = [], []
    model._epoch_stats_hook = lambda t, e, d: stats.append((t, e, {k: float(v) for k, v in d.items()}))
    for _ in range(dm.nb_tasks):
        model.incremental_train(dm)
        cnn, *_ = model.eval_task()
        model.after_task()
        curves.append(float(cnn["top1"]))
    return curves, stats


def _port_single(clip, state, keeps, log_dir):
    cfg = Config(**DP_CFG, log_dir=str(log_dir), device=["cpu"])
    dm = DataManager("synthetic_insects", shuffle=True, seed=7, init_cls=3, increment=3,
                     **DP_CFG["extras"]["dataset_kwargs"])
    model = get_model("proof", cfg, params_from_numpy(clip), proof_state=state)
    model._keep_masks_override = keeps
    # every step's gradients as the optimizer took them
    grads, step = [], tproof.train_step

    def recorded(tr, *a, **k):
        st = step(tr, *a, **k)
        grads.append([None if p.grad is None else p.grad.detach().clone().numpy()
                      for p in trainable_leaves(tr)])
        return st

    with pytest.MonkeyPatch.context() as m:
        m.setattr(tproof, "train_step", recorded)
        curves, stats = _run_protocol(model, dm)
    return {"curves": curves, "stats": stats, "cache_rows": len(model._feature_cache),
            "grads": grads,
            "params": [t.detach().numpy() for t in trainable_leaves(model.trainable)]}


def _jax_mesh_run(log_dir):
    cfg = JConfig(**DP_CFG, log_dir=str(log_dir), mesh_shape=[WORLD])
    dm = JDataManager("synthetic_insects", True, 7, 3, 3, **DP_CFG["extras"]["dataset_kwargs"])
    curves, stats = _run_protocol(jget_model("proof", cfg), dm)
    return {"curves": curves, "stats": stats}


def _clip_inputs():
    rng = np.random.default_rng(11)
    img = rng.standard_normal((8, 16)).astype(np.float32)
    txt = rng.standard_normal((8, 16)).astype(np.float32)
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=1, keepdims=True)
    img[6:], txt[6:] = img[:2], txt[:2]  # two padded rows on rank 1, repeating samples
    vm = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)
    return {"img": img, "txt": txt, "vm": vm, "scale": np.array(20.0, np.float32)}


def _tp_inputs(clip):
    rng = np.random.default_rng(12)
    tokens = Tokenizer()(["a photo of a larva", "an adult insect species 3", "egg", "pupa"])
    return {"clip": clip, "images": rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
            "tokens": np.asarray(tokens)}


def _int8_inputs(clip):
    rng = np.random.default_rng(13)

    def batches():  # one uint8 batch per rank, similar images (one colour each)
        base = rng.integers(60, 190, (WORLD, 1, 32, 32, 3))
        noise = rng.integers(-20, 21, (WORLD, 6, 32, 32, 3))
        return [np.clip(base[r] + noise[r], 0, 255).astype(np.uint8) for r in range(WORLD)]

    calib, gate = batches(), batches()
    return {"clip": clip, "calib": calib, "gate": gate,
            "images": rng.standard_normal((3, 32, 32, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_parallel")
    clip, state, rng, seq = _jax_init()
    keeps = JaxKeeps(rng, DP_CFG["batch_size"], seq, 32)
    single = _port_single(clip, state, keeps, d / "single")
    inputs = {
        "collectives": {"values": np.random.default_rng(15).standard_normal(
            (WORLD, 3, 4)).astype(np.float32)},
        "clip": _clip_inputs(),
        "shard": {"batch_sizes": [5, 1, 4], "n_rows": 11,
                  "rows": np.random.default_rng(14).standard_normal((11, 3)).astype(np.float32)},
        "tp": _tp_inputs(clip),
        "int8": _int8_inputs(clip),
        "dp_proof": {"cfg": DP_CFG, "clip": clip, "state": state, "keeps": keeps.drawn,
                     "log_dir": str(d / "dp")},
    }
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ)
    for k in ("XLA_FLAGS", "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(WORLD), str(d / "rdzv"),
                               str(d / "inputs.pkl"), str(d / f"rank{r}.pkl")],
                              env=env, cwd=str(WORKER.parents[1]), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    try:
        # team_tpu's side runs meanwhile
        jax_dp = _jax_mesh_run(d / "jax")
        outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    ranks = []
    for r in range(WORLD):
        with open(d / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {"ranks": ranks, "single": single, "jax_dp": jax_dp, "inputs": inputs}


def test_ranks_import_neither_jax_nor_team_tpu(world):
    for r, res in enumerate(world["ranks"]):
        assert res["modules"] == [], (r, res["modules"])
        assert f"world {WORLD}, rank {r}, backend gloo, transport host (gloo)" == res["describe"]


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_collectives_over_gloo(world, dtype):
    """bfloat16 crosses gloo as bytes (gathers) or float32 (reductions)."""
    vals = world["inputs"]["collectives"]["values"]
    if dtype == "torch.bfloat16":
        vals = torch.from_numpy(vals).to(torch.bfloat16).float().numpy()
    for res in world["ranks"]:
        out = res["collectives"][dtype]
        assert out["dtype"] == dtype
        np.testing.assert_array_equal(out["gather"], np.concatenate(list(vals)))
        np.testing.assert_array_equal(out["gather_cols"], np.concatenate(list(vals), axis=-1))
        np.testing.assert_array_equal(out["max"], vals.max(axis=0))
        np.testing.assert_array_equal(out["min"], vals.min(axis=0))
        want = vals.sum(axis=0)
        if dtype == "torch.bfloat16":  # one rounding of the float32 sum
            want = torch.from_numpy(want).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(out["sum"], want)
        np.testing.assert_array_equal(out["broadcast"], vals[0])


@pytest.mark.parametrize("local", [False, True], ids=["global", "local_loss"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "padded"])
def test_clip_loss_over_ranks_matches_shard_map(world, local, masked):
    inp = world["inputs"]["clip"]
    mesh = jmesh.make_mesh((WORLD,), ("data",))
    vm = jnp.asarray(inp["vm"]) if masked else jnp.ones(len(inp["vm"]), jnp.float32)

    def fn(a, t, v):
        return jclip_loss(a, t, jnp.asarray(inp["scale"]), axis_name="data", local_loss=local,
                          valid_mask=v if masked else None)[None]

    want = np.asarray(jax.shard_map(fn, mesh=mesh, in_specs=(P("data"), P("data"), P("data")),
                                    out_specs=P("data"))(inp["img"], inp["txt"], vm))
    got = np.array([res["clip"][(local, masked)][0] for res in world["ranks"]])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if not local:
        # every rank holds the global loss; its gradient reaches its own rows,
        # and the ranks' row gradients are the global loss's
        full = torch.from_numpy(inp["img"]).requires_grad_(True)
        from team_tpu_torch.losses.clip_loss import clip_loss

        clip_loss(full, torch.from_numpy(inp["txt"]), torch.tensor(inp["scale"]),
                  valid_mask=torch.from_numpy(inp["vm"]) if masked else None).backward()
        grads = np.concatenate([res["clip"][(local, masked)][1] for res in world["ranks"]])
        np.testing.assert_allclose(grads, full.grad.numpy(), rtol=1e-5, atol=1e-7)


def test_shard_batch_and_host_indices_match_team_tpu(world):
    inp = world["inputs"]["shard"]
    jctx = jmesh.MeshContext(jmesh.make_mesh((WORLD,), ("data",)))
    for r, res in enumerate(world["ranks"]):
        out = res["shard"]
        assert (out["n_data"], out["data_rank"]) == (WORLD, r)
        for n in inp["batch_sizes"]:
            tree = {"x": np.arange(n * 3, dtype=np.float32).reshape(n, 3), "y": [np.arange(n)]}
            want, valid = jctx.shard_batch(tree)
            per = want["x"].shape[0] // WORLD
            x, y, got_valid = out[n]
            assert got_valid == valid == n
            np.testing.assert_array_equal(x, np.asarray(want["x"])[r * per:(r + 1) * per])
            np.testing.assert_array_equal(y, np.asarray(want["y"][0])[r * per:(r + 1) * per])
        np.testing.assert_array_equal(out["indices"],
                                      jmesh.host_shard_indices(inp["n_rows"], r, WORLD))
        # [K, B, ...] with B split (team_tpu's P(None, data)); rank 0's values everywhere
        stacked = np.arange(3 * 4 * 2, dtype=np.float32).reshape(3, 4, 2)
        np.testing.assert_array_equal(out["stacked"], stacked[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["replicated"], np.zeros(3, np.float32))
        np.testing.assert_array_equal(out["gathered"], inp["rows"])
    chunks = [inp["rows"][tmesh.host_shard_indices(11, h, 3)] for h in range(3)]
    np.testing.assert_array_equal(tmesh.gather_host_shards(chunks, 11),
                                  jmesh.gather_host_shards(chunks, 11))


def test_tp_encode_matches_team_tpu(world):
    inp = world["inputs"]["tp"]
    cfg = jclip.CLIPConfig.tiny()
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(1, WORLD), ("data", "model"))
    params = jmesh.shard_clip_params(jax.tree_util.tree_map(jnp.asarray, inp["clip"]), mesh)
    rep = NamedSharding(mesh, P())
    jms.set_tp_mesh(mesh)
    jms._FORCE_INTERPRET = True
    try:
        with mesh:
            img = jax.jit(lambda p, x: jclip.encode_image(p, x, cfg, attn_impl="mha_packed_tp"))(
                params, jax.device_put(inp["images"], rep))
            txt = jax.jit(lambda p, t: jclip.encode_text(p, t, cfg, attn_impl="mha_packed_tp"))(
                params, jax.device_put(inp["tokens"], rep))
    finally:
        jms.set_tp_mesh(None)
        jms._FORCE_INTERPRET = False
    for r, res in enumerate(world["ranks"]):
        out = res["tp"]
        assert out["model_rank"] == r and out["qkv_w_cols"] == 3 * cfg.vision.width // WORLD
        np.testing.assert_allclose(out["image"], np.asarray(img), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["text"], np.asarray(txt), rtol=1e-5, atol=1e-5)
    # and the port's single-device tower
    tp = params_from_numpy(inp["clip"])
    np.testing.assert_allclose(world["ranks"][0]["tp"]["image"],
                               tclip.encode_image(tp, torch.from_numpy(inp["images"]),
                                                  tclip.CLIPConfig.tiny()).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_int8_calibration_over_ranks(world):
    inp = world["inputs"]["int8"]
    r0, r1 = (res["int8"] for res in world["ranks"])
    # the abs-maxes combined by max, exactly: one payload on every rank
    combined = jax.tree_util.tree_map(lambda a, b: torch.maximum(a, b), r0["local_stats"],
                                      r1["local_stats"])
    params = {"vision": params_from_numpy(inp["clip"])["vision"]}
    want = tquant.quantize_vision_tower_static(params, combined,
                                               heads=tclip.CLIPConfig.tiny().vision.heads)
    for res in (r0, r1):
        for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                     jax.tree_util.tree_flatten_with_path(res["qvision"])[0]):
            assert torch.equal(a, b), jax.tree_util.keystr(path)
    # one gate decision: the smaller of the ranks' min cosines
    assert r0["gate_cosine"] == r1["gate_cosine"] and r0["committed"] == r1["committed"]
    cfg = Config(convnet_type="clip", device=["cpu"], encoder_quant="int8_static",
                 compute_dtype="bfloat16", extras={"tiny_backbone": True})
    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime

    rt = BackboneRuntime(cfg, params=params_from_numpy(inp["clip"]))
    mins = []
    for batch in inp["gate"]:
        x = torch.from_numpy(batch)
        ref = rt._calib_forward(x)[1].double()
        got = rt._encode_int8(want, x).double()
        mins.append(float(torch.nn.functional.cosine_similarity(ref, got, dim=-1).min()))
    assert r0["gate_cosine"] == pytest.approx(min(mins), rel=1e-12)
    # the q3i attention head-split over the ranks: the whole-head tower bit for bit
    for res in (r0, r1):
        assert res["tp_calls"] == tclip.CLIPConfig.tiny().vision.layers
        np.testing.assert_array_equal(res["split"], res["whole"])


def test_dp_proof_equals_single_process(world):
    single = world["single"]
    for res in world["ranks"]:
        dp = res["dp_proof"]
        assert dp["curves"] == single["curves"]
        assert dp["cache_rows"] == single["cache_rows"]
        assert [k[:3] for k in dp["keep_calls"]] == sorted(world["inputs"]["dp_proof"]["keeps"])
        for a, b in zip(dp["params"], single["params"]):
            np.testing.assert_allclose(a, b, atol=2e-5, rtol=2e-4)
        assert len(dp["stats"]) == len(single["stats"]) == 4
        for (t0, e0, d0), (t1, e1, d1) in zip(single["stats"], dp["stats"]):
            assert (t0, e0) == (t1, e1) and d0["correct"] == d1["correct"] and d0["n"] == d1["n"]
            for k in ("total", "ce", "clip", "unicl"):
                assert abs(d0[k] - d1[k]) <= 1e-5 * max(1.0, abs(d0[k])), (t0, e0, k)
    a, b = (res["dp_proof"]["params"] for res in world["ranks"])
    assert all(np.array_equal(x, y) for x, y in zip(a, b))  # one replicated state


def test_dp_proof_gradients_equal_single_process(world):
    """The gradients every step hands the optimizer: summed over the ranks,
    they are the single process's. AdamW's update does not see a gradient
    scaled by a constant, so the curves and parameters alone would pass a
    step off by the world size (averaged, or logit_scale live on every
    rank); the gradients do not."""
    single = world["single"]["grads"]
    assert len(single) == 10  # 2 epochs of 2 batches (30 rows), then of 3 (42 rows)
    for res in world["ranks"]:
        dp = res["dp_proof"]["grads"]
        assert len(dp) == len(single)
        for step, (gd, gs) in enumerate(zip(dp, single)):
            assert len(gd) == len(gs)
            for leaf, (a, b) in enumerate(zip(gd, gs)):
                assert (a is None) == (b is None), (step, leaf)
                if b is not None:
                    scale = max(float(np.abs(b).max()), 1e-12)
                    assert float(np.abs(a - b).max()) <= 1e-4 * scale, (step, leaf)


def test_features_outside_the_cache_are_encoded_over_the_ranks(world):
    """Each rank encodes its interleaved share of an uncached dataset and the
    shares come back in dataset order, with their labels and stage ids."""
    for res in world["ranks"]:
        dp = res["dp_proof"]
        feats, labels, stages = dp["sharded_feats"]
        np.testing.assert_allclose(feats, dp["cached_feats"][0], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(labels, dp["labels"])
        np.testing.assert_array_equal(stages, dp["stages"])


def test_dp_proof_matches_team_tpu_mesh(world):
    want = world["jax_dp"]
    got = world["ranks"][0]["dp_proof"]
    assert len(want["curves"]) == len(got["curves"]) == 2
    for w, g in zip(want["curves"], got["curves"]):
        assert abs(w - g) <= 0.1, (want["curves"], got["curves"])
    assert len(want["stats"]) == len(got["stats"]) == 4
    for (t0, e0, d0), (t1, e1, d1) in zip(want["stats"], got["stats"]):
        assert (t0, e0) == (t1, e1) and d0["n"] == d1["n"] and d0["correct"] == d1["correct"]
        for k in ("total", "ce", "clip", "unicl"):
            assert abs(d0[k] - d1[k]) <= 1e-3 * max(1.0, abs(d0[k])), (t0, e0, k, d0[k], d1[k])


# ---------------------------------------------------------------------------
# the head-split kernels' plain versions (this process, no world)
# ---------------------------------------------------------------------------

class _Layout:
    def __init__(self, rank, nm):
        self.model_rank, self.n_model = rank, nm


def _jax_tp(fn, nm):
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(8 // nm, nm), ("data", "model"))
    jms.set_tp_mesh(mesh)
    try:
        return np.asarray(fn())
    finally:
        jms.set_tp_mesh(None)


def _port_ranks(fn, nm):
    outs = []
    try:
        for r in range(nm):
            tms.set_tp_mesh(_Layout(r, nm))
            outs.append(fn().numpy())
    finally:
        tms.set_tp_mesh(None)
    return outs


@pytest.mark.parametrize("causal", [False, True], ids=["vision", "causal"])
@pytest.mark.parametrize("nm", [2, 4])
def test_mha_packed_tp_plain_matches_team_tpu(nm, causal):
    rng = np.random.default_rng(nm)
    b, s, d, heads = 8, 11, 64, 4
    qkv = rng.standard_normal((b, s, 3 * d)).astype(np.float32)
    want = _jax_tp(lambda: jms.fused_mha_packed_tp(jnp.asarray(qkv), heads, causal=causal,
                                                   interpret=True), nm)
    outs = _port_ranks(lambda: tms.fused_mha_packed_tp(torch.from_numpy(qkv), heads,
                                                       causal=causal), nm)
    dm = d // nm
    for r, out in enumerate(outs):
        assert out.shape == (b, s, dm)
        np.testing.assert_allclose(out, want[..., r * dm:(r + 1) * dm], rtol=2e-5, atol=2e-5)
        np.testing.assert_array_equal(out, tms.mha_packed_tp_plain(
            torch.from_numpy(qkv), heads, r, nm, causal=causal).numpy())
    # the ranks side by side are the whole-head kernel's plain version
    whole = tms.fused_mha_packed(torch.from_numpy(qkv), heads, causal=causal).numpy()
    np.testing.assert_array_equal(np.concatenate(outs, axis=-1), whole)


def _q3i_inputs(rng, d, heads):
    dh = d // heads
    qkv_q = rng.integers(-127, 128, (8, 11, 3 * d), dtype=np.int8)
    sq, sk = (rng.uniform(0.01, 0.05, heads).astype(np.float32) for _ in range(2))
    deq = np.concatenate([np.repeat(sq, dh), np.repeat(sk, dh),
                          rng.uniform(0.01, 0.05, d).astype(np.float32)])[None, :]
    qks = (sq * sk * dh ** -0.5)[None, :].astype(np.float32)
    oinv = rng.uniform(5.0, 20.0, d).astype(np.float32)[None, :]
    m2 = rng.uniform(2.0, 6.0, heads).astype(np.float32)[None, :]
    return qkv_q, deq, qks, oinv, m2


@pytest.mark.parametrize("mode", ["static", "rowmax", "causal"])
@pytest.mark.parametrize("nm", [2, 4])
def test_mha_packed_q3i_tp_plain_matches_team_tpu(nm, mode):
    """Bit for bit, as team_tpu's own test holds its head split."""
    rng = np.random.default_rng(10 + nm)
    d, heads = 64, 4
    qkv_q, deq, qks, oinv, m2 = _q3i_inputs(rng, d, heads)
    m2 = m2 if mode == "static" else None
    causal = mode == "causal"
    want = _jax_tp(lambda: jms.fused_mha_packed_q3i_tp(
        *map(jnp.asarray, (qkv_q, deq, qks, oinv)), heads, causal=causal, interpret=True,
        qk_m2=None if m2 is None else jnp.asarray(m2)), nm)
    outs = _port_ranks(lambda: tms.fused_mha_packed_q3i_tp(
        *map(torch.from_numpy, (qkv_q, deq, qks, oinv)), heads, causal=causal,
        qk_m2=None if m2 is None else torch.from_numpy(m2)), nm)
    dm = d // nm
    for r, out in enumerate(outs):
        assert out.dtype == np.int8 and out.shape == (8, 11, dm)
        np.testing.assert_array_equal(out, want[..., r * dm:(r + 1) * dm])
    np.testing.assert_array_equal(np.concatenate(outs, axis=-1), tms.fused_mha_packed_q3i(
        *map(torch.from_numpy, (qkv_q, deq, qks, oinv)), heads, causal=causal,
        qk_m2=None if m2 is None else torch.from_numpy(m2)).numpy())


@pytest.mark.parametrize("layout", ["none", "nm1", "heads_indivisible"])
def test_head_split_falls_back_to_the_whole_head_kernel(layout):
    """team_tpu's routing: no layout, one model rank or heads that do not
    split run the whole-head kernel and return ``[B, S, D]``."""
    rng = np.random.default_rng(20)
    qkv = torch.from_numpy(rng.standard_normal((2, 5, 3 * 48)).astype(np.float32))
    qkv_q, deq, qks, oinv, _ = _q3i_inputs(rng, 48, 3)
    q_args = tuple(map(torch.from_numpy, (qkv_q, deq, qks, oinv)))
    tms.set_tp_mesh({"none": None, "nm1": _Layout(0, 1),
                     "heads_indivisible": _Layout(1, 2)}[layout])
    try:
        got = tms.fused_mha_packed_tp(qkv, 3)
        got_q = tms.fused_mha_packed_q3i_tp(*q_args, 3)
    finally:
        tms.set_tp_mesh(None)
    torch.testing.assert_close(got, tms.fused_mha_packed(qkv, 3), rtol=0, atol=0)
    assert torch.equal(got_q, tms.fused_mha_packed_q3i(*q_args, 3))


# ---------------------------------------------------------------------------
# layouts: one device per rank, the backend from the layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device,local_world,want,backend", [
    ([0], 1, ["cuda:0"], "nccl"),
    ([1, 2], 1, ["cuda:1"], "nccl"),          # one process runs on the first
    ([0], 2, ["cuda:0", "cuda:1"], "nccl"),   # torchrun: cuda:LOCAL_RANK
    ([0, 0], 2, ["cuda:0", "cuda:0"], "gloo"),  # two ranks share a card
    (["cpu"], 2, ["cpu", "cpu"], "gloo"),
    (["cuda:3", "cuda:1"], 2, ["cuda:3", "cuda:1"], "nccl"),
])
def test_rank_devices_and_backend(device, local_world, want, backend):
    devs = tlayout.rank_devices(device, local_world)
    assert [str(d) for d in devs] == want
    assert tlayout.backend_for(devs) == backend


def test_a_device_list_of_the_wrong_length_raises():
    with pytest.raises(ValueError):
        tlayout.rank_devices([0, 1, 2], 2)


def test_a_mesh_larger_than_the_world_raises():
    with pytest.raises(ValueError, match="torchrun"):
        tmesh.make_mesh([2], device=["cpu"])


def test_cli_under_torchrun_runs_a_mesh_config(tmp_path):
    """``torchrun --nproc_per_node 2 -m team_tpu_torch.main`` on a
    ``mesh_shape: [2]`` PROOF config (the smoke config on the CPU): both ranks
    join over ``env://``, gloo from the layout, and only rank 0 writes the
    log and ``metrics.jsonl``."""
    cfg = json.loads((WORKER.parents[1] / "exps" / "synthetic_smoke.json").read_text())
    cfg.update(device=["cpu"], mesh_shape=[WORLD], tuned_epoch=1, log_dir=str(tmp_path / "logs"),
               dataset_kwargs={"num_classes": 4, "img_size": 32})
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(WORLD), "-m", "team_tpu_torch.main", "--config", str(tmp_path / "cfg.json")],
        cwd=str(WORKER.parents[1]), env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    metrics = list((tmp_path / "logs").rglob("metrics.jsonl"))
    assert len(metrics) == 1
    assert len(metrics[0].read_text().splitlines()) == 2  # one line per task, rank 0 only
    logs = list((tmp_path / "logs").rglob("*.log"))
    assert len(logs) == 1
    assert f"world {WORLD}, rank 0, backend gloo, transport host (gloo)" in logs[0].read_text()
