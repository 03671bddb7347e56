"""The port's paths end to end on the card, through the kernels.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false, as on a CPU-only host. The file imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_card_paths.py

At full ViT-B/16 width (random init from a seed) on the card:
- the learners through ``team_tpu_torch.trainer.train`` on a 4-class
  ``synthetic_insects`` set, each with the kernels' launch counts zeroed
  just before its run and read just after: SimpleCIL (bf16) and ZS-CLIP
  (f32) on the default route, PROOF on the flash route (with its loss and
  gradients on the card against the CPU within 1e-4 relative), both towers
  on the fused routes, SimpleCIL on every int8 static route and on the
  dynamic tiers, whose gates must decide by the >= 0.999 rule; every
  accuracy curve in [0, 100];
- the features of the kernel routes against the plain routes (float32
  cosine >= 0.99999, bf16 >= 0.99), and every int8 payload (each route's
  own, and the configurations served from another route's) through its
  kernels with each int8 kernel call held against its plain version on the
  tower's own inputs (one int8 step on under 1 % of the outputs, the static
  epilogues as in ``tests/test_torch_cuda.py``), its features against the
  plain versions at cosine >= 0.9999 and 5e-2 rms (the attention kernels
  alone 5e-3 rms);
- the int8 text tower on the class prompts; the backwards of #1, #3, #13
  and #14 against autograd of their plain references (1e-4 of the largest
  gradient in float32, 2e-2 in bf16); Grad-CAM on each kernel route against
  the plain route (1e-3); resume; the ten-task PROOF protocol pinned to
  ``team_tpu_torch/scripts/goldens/h100_protocol_proof_bf16.json``; data and
  tensor parallelism with two gloo ranks on the one card
  (``tests/torch_card_parallel_worker.py``); the probe scripts; the
  open_clip loader."""

import contextlib
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from team_tpu_torch.backbone import quant
from team_tpu_torch.ops import flash_attention as fa
from team_tpu_torch.ops import int8_matmul as im
from team_tpu_torch.ops import mha_short as ms
from card_helpers import (DATASET, EVAL_B, FLAGSHIP_BATCH, GRAD_STEPS, launch_counts,
                          proof_config, pv_int8_limit, record_launches, recording, smoke_config,
                          train_recording, tp_weights_and_images, zero_launches)

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
BF16_STEP = 2.0 ** -7
INT8_MAX_FRAC = 0.01  # int8 kernels: at most one int8 step, on under 1 % of the outputs
EPILOGUE_MAX_FRAC = 0.001  # the static epilogues with a GELU and ln_quant_folded: under 0.1 %
STATIC_EPILOGUES = ("static_requant", "static_residual", "ln_quant_folded")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _counted(fn, calls: dict, key: str):
    """``fn`` that adds one to ``calls[key]`` on each call."""
    def wrapped(*args, **kwargs):
        calls[key] += 1
        return fn(*args, **kwargs)
    return wrapped


def _count_encodes(calls: dict):
    """A ``recording`` set-up that counts a runtime's int8 batches and its
    calibration forwards (the bf16 tower) in ``calls``."""
    def setup(rt):
        for key, attr in (("int8", "_encode_int8"), ("calib", "_calib_forward")):
            setattr(rt, attr, _counted(getattr(rt, attr), calls, key))
    return setup


def _count_towers(calls: dict):
    """A ``recording`` set-up that counts a runtime's image-tower and
    text-tower calls in ``calls``."""
    def setup(rt):
        for key, attr in (("image", "encode_image"), ("text", "encode_text_tokens")):
            setattr(rt, attr, _counted(getattr(rt, attr), calls, key))
    return setup


def assert_curve(res, keys=("cnn_top1", "cnn_top5")):
    accs = [float(a) for k in keys for a in res[k]]
    assert len(res["cnn_top1"]) == 2 and all(0.0 <= a <= 100.0 for a in accs), res


def _cos(a, b) -> float:
    return torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=-1).min().item()


# -- the learners through the trainer --------------------------------------

@pytest.mark.parametrize("model_name,dtype", [("simplecil", "bfloat16"), ("zs_clip", "float32")])
def test_learners_on_the_default_route_launch_the_packed_kernel(cuda_device, tmp_path,
                                                                 record_property, model_name,
                                                                 dtype):
    """Both towers' attention through #1, one launch a block of every tower
    call: the layers times the image-tower and text-tower calls, the causal
    ones the layers times the text-tower calls, both non-zero."""
    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime
    from team_tpu_torch.trainer import train

    calls = {"image": 0, "text": 0}
    with recording(BackboneRuntime, _count_towers(calls)) as made:
        zero_launches()
        res = train(smoke_config(model_name, dtype, tmp_path))
        launches, causal = ms.fused_mha_packed.launches, ms.fused_mha_packed.causal_launches
        record_launches(record_property)
    assert len(made) == 1 and calls["image"] > 0 and calls["text"] > 0, (made, calls)
    layers = made[0].clip_cfg.vision.layers
    assert (launches, causal) == (layers * (calls["image"] + calls["text"]),
                                  layers * calls["text"]), (launches, causal, calls)
    assert_curve(res)


# (model, dtype, attention_impl, extra config) of the fused routes' runs
FUSED_RUNS = [("proof", "bfloat16", "attn_block", {"batch_size": FLAGSHIP_BATCH, "tuned_epoch": 2}),
              ("simplecil", "bfloat16", "mha_packed_proj", {}),
              ("zs_clip", "float32", "attn_block", {})]


@pytest.mark.parametrize("model_name,dtype,impl,kw", FUSED_RUNS,
                         ids=[f"{m}-{i}" for m, _, i, _ in FUSED_RUNS])
def test_learners_on_the_fused_routes_launch_a_kernel_a_block(cuda_device, tmp_path,
                                                             record_property, model_name, dtype,
                                                             impl, kw):
    """Every block of every tower call goes through the route's kernel: its
    launches are the layers times the image-tower calls (non-causal) and the
    text-tower calls (causal), both non-zero; attn_block's second kernel
    launches once with each first; the packed and flash kernels launch no
    time."""
    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime
    from team_tpu_torch.trainer import train

    calls = {"image": 0, "text": 0}
    with recording(BackboneRuntime, _count_towers(calls)) as made:
        zero_launches()
        res = train(smoke_config(model_name, dtype, tmp_path, attention_impl=impl, **kw))
        record_launches(record_property)
        block, proj = ms.fused_attn_block, ms.fused_mha_packed_proj
        got = {"attn_block": block.launches, "attn_block_causal": block.causal_launches,
               "attn_block_proj": block.proj_launches, "mha_packed_proj": proj.launches,
               "mha_packed_proj_causal": proj.causal_launches,
               "fused_mha_packed": ms.fused_mha_packed.launches,
               "flash_attention": fa.flash_attention.launches,
               "fused_mha_short": ms.fused_mha_short.launches}
    assert len(made) == 1 and calls["image"] > 0 and calls["text"] > 0, (made, calls)
    layers = made[0].clip_cfg.vision.layers
    n, causal = layers * (calls["image"] + calls["text"]), layers * calls["text"]
    want = dict.fromkeys(got, 0)
    if impl == "attn_block":
        want.update(attn_block=n, attn_block_causal=causal, attn_block_proj=n)
    else:
        want.update(mha_packed_proj=n, mha_packed_proj_causal=causal)
    assert got == want
    assert_curve(res)


def test_proof_on_the_flash_route(cuda_device, tmp_path, record_property):
    """PROOF (bf16, batch 16, two tasks of two epochs) with attention_impl
    "pallas": finite losses, flash launches in both towers; then its loss,
    the loss's parts and its gradients on one batch of its own train
    features, with fixed dropout keeps, on the card and on the CPU (float32)
    within 1e-4 relative."""
    from team_tpu_torch.bridge import tree_to
    from team_tpu_torch.learners import proof as proof_learner
    from team_tpu_torch.learners import proof_net as pn
    from team_tpu_torch.modules.fusion import draw_keep_masks
    from team_tpu_torch.trainer import train

    losses = []

    def record_losses(learner):
        learner._epoch_stats_hook = lambda task, epoch, st: losses.append((task, epoch, st))

    with recording(proof_learner.Learner, record_losses) as made:
        zero_launches()
        res = train(smoke_config("proof", "bfloat16", tmp_path, batch_size=FLAGSHIP_BATCH,
                                 attention_impl="pallas", tuned_epoch=2))
        flash, causal = fa.flash_attention.launches, fa.flash_attention.causal_launches
        record_launches(record_property)
    assert len(made) == 1
    assert len(losses) == 4 and all(math.isfinite(st[k]) for _, _, st in losses
                                    for k in ("total", "ce", "clip", "unicl")), losses
    assert causal > 0 and flash - causal > 0, (flash, causal)
    assert_curve(res, ("cnn_top1", "cnn_top5", "nme_top1"))

    model = made[0]
    feats, labels, stages = model._train_feats
    n = min(FLAGSHIP_BATCH, len(labels))
    batch = {"feat": torch.from_numpy(feats[:n].astype("float32")),
             "label": torch.from_numpy(labels[:n].astype("int64")),
             "stage_id": torch.from_numpy(stages[:n].astype("int64")),
             "valid_mask": torch.ones(n)}
    dims = model.dims
    keeps = draw_keep_masks(n, 3 + dims.max_classes + dims.max_tasks * dims.ctx_len,
                            dims.feature_dim, 1, 0.1, torch.Generator().manual_seed(0), "cpu")

    def leaves_on(tree, dev):
        if isinstance(tree, dict):
            return {k: leaves_on(v, dev) for k, v in tree.items()}
        return tree.detach().to(dev).clone().requires_grad_(True)

    out = {}
    for dev in (model.device, torch.device("cpu")):
        tr = leaves_on(model.trainable, dev)
        leaves = pn.trainable_leaves(tr)
        ctx = pn.TaskContext(*(t.to(dev) for t in model.ctx))
        buffers = pn.ProofBuffers(*(t.to(dev) for t in model.buffers))
        loss, st = pn.proof_loss(tr, tree_to(batch, dev), ctx, buffers, 1,
                                 keep_masks=tuple(m.to(dev) for m in keeps), **model._loss_kwargs)
        loss.backward()
        out[dev.type] = ([float(t.detach()) for t in st[:4]],
                         torch.cat([x.grad.flatten().cpu() for x in leaves]))
    (card, g_card), (cpu, g_cpu) = out["cuda"], out["cpu"]
    rel = max(abs(a - b) / max(abs(b), 1e-6) for a, b in zip(card, cpu))
    grad_rel = float((g_card - g_cpu).abs().max() / g_cpu.abs().max().clamp_min(1e-12))
    assert all(math.isfinite(x) for x in card) and rel <= 1e-4 and grad_rel <= 1e-4, \
        (card, cpu, rel, grad_rel)


def test_proof_resumes_to_the_whole_runs_curves(cuda_device, tmp_path):
    """PROOF (bf16, batch 16, tuned_epoch 2, the default route) with
    checkpoint_dir: the whole run, then its last task's file deleted and the
    run resumed; the resumed curves equal the whole run's bit for bit."""
    from team_tpu_torch.trainer import train

    ckpt = tmp_path / "ckpt"

    def cfg(resume):
        return smoke_config("proof", "bfloat16", tmp_path / "log", batch_size=FLAGSHIP_BATCH,
                            tuned_epoch=2, checkpoint_dir=str(ckpt), resume=resume)

    whole = train(cfg(False))
    assert sorted(os.listdir(ckpt)) == ["task_0.pt", "task_1.pt"]
    os.remove(ckpt / "task_1.pt")
    resumed = train(cfg(True))
    for key in ("cnn_top1", "cnn_top5", "nme_top1"):
        assert [float(a) for a in whole[key]] == [float(a) for a in resumed[key]], key


def test_full_protocol_proof_bf16_holds_its_golden(cuda_device, tmp_path):
    """``team_tpu_torch.scripts.full_protocol`` in a fresh process, as a user
    runs it (TF32 off): PROOF in bf16, ten tasks at the flagship's shape,
    above its floor and equal to its committed golden."""
    code = ("import json, sys, torch\n"
            "torch.backends.cuda.matmul.allow_tf32 = False\n"
            "torch.backends.cudnn.allow_tf32 = False\n"
            "from team_tpu_torch.scripts import full_protocol as fp\n"
            "res = fp.run(fp.protocol_config('proof', 'bf16', device=[0], log_dir=sys.argv[1]),"
            " pin='1')\n"
            "print(json.dumps({'curve': res['curve'], 'pin': res['pin']}))\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    import json

    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(res["curve"]) == 10 and res["pin"].startswith("golden pin OK"), res


# -- the int8 static tier through the trainer ------------------------------

def STATIC3D_EPILOGUES(n: int) -> dict:
    """The static epilogues of a static3d route's n-layer tower, per int8
    batch: two layer norms to int8, two requantizes (qkv, fc) and two
    residual epilogues (out, proj) a block."""
    return {"ln_quant_folded": 2 * n, "static_requant": 2 * n, "static_residual": 2 * n}


# the int8 runs besides static3d_qi: name -> (int8_gemm_impl, knobs, each
# kernel's launches per int8 batch of an L-layer tower: a requantize after
# each int8-out GEMM, a bf16 epilogue after each bf16-out one (the out and
# proj GEMMs with the residual), _ln_quant3's kernel for each layer norm that
# it produces)
INT8_ROUTES = {
    "static_qa": ("static_qa", {}, lambda n: {"ln_quantize_static": 2 * n,
                                              "fused_mha_packed_q": n, "static_requant": 2 * n,
                                              "static_residual": 2 * n}),
    "static": ("static", {}, lambda n: {"ln_quantize_static": 2 * n, "row_quant_static": n,
                                        "fused_mha_packed": n, "static_requant": n,
                                        "static_residual": 3 * n}),
    "static3d_qaf": ("static3d_qaf", {}, lambda n: {"fused_mha_packed_q3": n,
                                                    **STATIC3D_EPILOGUES(n)}),
    "static3d_qis": ("static3d_qis", {}, lambda n: {"fused_mha_packed_q3i_sb": n,
                                                    **STATIC3D_EPILOGUES(n)}),
    "kqs": ("static3d_qi", {"TEAM_CLS_LAST": "kqs"},
            lambda n: {"fused_mha_packed_q3i": n - 1, "fused_mha_packed_q3i_cls_split": 1,
                       **STATIC3D_EPILOGUES(n), "static_requant": 2 * n + 1}),
}
Q3I_COUNTERS = ("fused_mha_packed_q3i", "fused_mha_packed_q3i_cls",
                "fused_mha_packed_q3i_cls_split", "fused_mha_packed_q3i_sb")
INT8_COUNTERS = ("ln_quantize_static", "row_quant_static", "ln_quant_folded", "static_requant",
                 "static_residual", "fused_mha_packed_q", "fused_mha_packed_q3", *Q3I_COUNTERS)


def _int8_counter(name):
    return getattr(im, name, None) or getattr(ms, name)


class Int8Runs:
    """SimpleCIL (bf16, batch 16) through the trainer on the int8 static tier,
    one run for each route, each with its own payload cache (a payload holds
    every static route's keys), made once and kept for the tests that load
    its payload."""

    def __init__(self, root: Path):
        self.root, self.done = root, {}

    def cache(self, run: str) -> str:
        return str(self.root / run / "cache")

    def get(self, run: str) -> dict:
        if run not in self.done:
            self.done[run] = self._train(run)
        return self.done[run]

    def _train(self, run: str) -> dict:
        from team_tpu_torch.learners.backbone_runtime import BackboneRuntime
        from team_tpu_torch.trainer import train

        extras = {"int8_cache_dir": self.cache(run)}
        env = {}
        if run in INT8_ROUTES:
            route, env, _ = INT8_ROUTES[run]
            extras["int8_gemm_impl"] = route
        calls = {"int8": 0, "calib": 0}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            with recording(BackboneRuntime, _count_encodes(calls)) as made:
                zero_launches()
                res = train(smoke_config("simplecil", "bfloat16", self.root / run / "log",
                                         batch_size=FLAGSHIP_BATCH, encoder_quant="int8_static",
                                         extras=extras))
                got = {name: _int8_counter(name).launches for name in INT8_COUNTERS}
                got["fused_mha_packed"] = (ms.fused_mha_packed.launches
                                           - ms.fused_mha_packed.causal_launches)
                every = launch_counts()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        return {"res": res, "made": made, "launches": got, "calls": calls, "every": every}


@pytest.fixture(scope="module")
def int8_runs(tmp_path_factory):
    return Int8Runs(tmp_path_factory.mktemp("int8_runs"))


def _committed(run: dict):
    made = run["made"]
    assert len(made) == 1 and made[0].int8_committed and made[0].encoder_quant == "int8_static", \
        "the int8 path fell back to bf16: the quantized tower was not committed"
    return made[0]


def test_simplecil_on_the_int8_static_tier(cuda_device, int8_runs, record_property):
    """The default route, static3d_qi: the quantized tower is committed, and
    every int8 batch runs the integer-QKᵀ kernel in 11 blocks, the CLS
    kernel in the last and each static epilogue kernel its count."""
    run = int8_runs.get("static3d_qi")
    record_launches(record_property, run["every"])
    rt = _committed(run)
    layers = rt.clip_cfg.vision.layers
    got = run["launches"]
    q3i, cls = got["fused_mha_packed_q3i"], got["fused_mha_packed_q3i_cls"]
    assert cls > 0 and q3i == (layers - 1) * cls, (q3i, cls)
    assert {name: got[name] for name in STATIC_EPILOGUES} == {
        name: k * cls for name, k in STATIC3D_EPILOGUES(layers).items()}, got
    assert_curve(run["res"])


@pytest.mark.parametrize("run_name", list(INT8_ROUTES))
def test_simplecil_on_each_int8_route_launches_its_kernels(cuda_device, int8_runs,
                                                           record_property, run_name):
    """Each route (under its knobs) commits the quantized tower, and each of
    its kernels launches exactly its count in every int8 batch (the packed
    kernel also once a block of each calibration forward, which is the bf16
    tower); no other int8 kernel launches."""
    run = int8_runs.get(run_name)
    record_launches(record_property, run["every"])
    rt = _committed(run)
    layers = rt.clip_cfg.vision.layers
    per_batch = INT8_ROUTES[run_name][2](layers)
    calls, got = run["calls"], run["launches"]
    want = {name: calls["int8"] * per_batch.get(name, 0) for name in got}
    want["fused_mha_packed"] += layers * calls["calib"]
    assert calls["int8"] > 0 and got == want and all(got[n] for n in per_batch), (got, want)
    assert_curve(run["res"])


# the dynamic tiers' kernels (int8_matmul wrappers) and their calls per block
TIER_PER_BLOCK = {
    "hybrid": {"ln_quantize": 2, "int8_linear": 0, "int8_linear_gelu_quant": 1,
               "int8_linear_blockscale": 1},
    "pallas": {"ln_quantize": 2, "int8_linear": 2, "int8_linear_gelu_quant": 1,
               "int8_linear_blockscale": 1},
}
TIER_KERNELS = tuple(TIER_PER_BLOCK["pallas"])


@pytest.mark.parametrize("tier", list(TIER_PER_BLOCK))
def test_simplecil_on_the_dynamic_tiers_gates_by_the_rule(cuda_device, tmp_path,
                                                          record_property, tier):
    """hybrid and pallas at batch 16, each with its own payload cache: as in
    team_tpu the runtime builds the static payload and gates it through the
    tier's blocks; the decision follows the rule (min cosine >= 0.999
    commits, else bf16 from then on), and each of the tier's kernels
    launches exactly its count a block in every int8 batch (the gate batch,
    and every later one if it committed), with no other int8 kernel."""
    from team_tpu_torch.learners.backbone_runtime import GATE_MIN_COSINE, BackboneRuntime
    from team_tpu_torch.trainer import train

    calls = {"int8": 0, "calib": 0}
    with recording(BackboneRuntime, _count_encodes(calls)) as made:
        zero_launches()
        res = train(smoke_config("simplecil", "bfloat16", tmp_path, batch_size=FLAGSHIP_BATCH,
                                 encoder_quant="int8_static",
                                 extras={"int8_cache_dir": str(tmp_path / "cache"),
                                         "int8_gemm_impl": tier}))
        got = {name: getattr(im, name).launches for name in TIER_KERNELS}
        stray = {name: _int8_counter(name).launches
                 for name in ("ln_quantize_static", "row_quant_static", *Q3I_COUNTERS)}
        record_launches(record_property)
    assert len(made) == 1
    rt = made[0]
    passed = rt.gate_cosine is not None and rt.gate_cosine >= GATE_MIN_COSINE
    assert rt.int8_committed == passed
    assert rt.encoder_quant == ("int8_static" if passed else "bf16"), rt.encoder_quant
    assert (calls["int8"] == 1) != passed, (calls, rt.gate_cosine)
    layers = rt.clip_cfg.vision.layers
    want = {name: calls["int8"] * layers * n for name, n in TIER_PER_BLOCK[tier].items()}
    assert calls["int8"] > 0 and got == want and not any(stray.values()), (got, want, stray)
    assert_curve(res)


# -- features at full width against the plain versions --------------------

@pytest.fixture(scope="module")
def smoke_images():
    """8 test images of the 4-class synthetic set (uint8, 224²) and the
    class prompts."""
    from team_tpu_torch.data import DataManager

    dm = DataManager("synthetic_insects", True, 1, 2, 2, **DATASET)
    images = np.stack(dm.get_dataset(np.arange(4), source="test", mode="test").images[:8])
    prompts = [t.format(c) for c in dm._class_to_label for t in dm._data_to_prompt]
    return images, prompts


@pytest.fixture(scope="module")
def vitb16_params():
    from team_tpu_torch.backbone.clip import CLIPConfig, init_clip_params

    return init_clip_params(torch.Generator().manual_seed(0), CLIPConfig.vit_b16())


MIN_COS = {"float32": 0.99999, "bfloat16": 0.99}


def _runtime(dtype, route, params, **kw):
    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime

    return BackboneRuntime(smoke_config("simplecil", dtype, "", attention_impl=route, **kw),
                           params=params)


def _assert_features(got, want, out_dim, min_cos):
    assert got.shape == (len(want), out_dim) and bool(torch.isfinite(got).all())
    assert _cos(got, want) >= min_cos, _cos(got, want)


@pytest.mark.parametrize("route", ["auto", "pallas"])
@pytest.mark.parametrize("dtype", list(MIN_COS))
def test_towers_at_full_width_match_plain_attention(cuda_device, smoke_images, vitb16_params,
                                                    dtype, route):
    """Both towers through the packed (auto) and flash (pallas) kernels
    against the plain-attention towers (xla) on the same weights."""
    images, prompts = smoke_images
    plain = _runtime(dtype, "xla", vitb16_params)
    rt = _runtime(dtype, route, vitb16_params)
    _assert_features(rt.encode_image(rt.to_device(images)),
                     plain.encode_image(plain.to_device(images)), rt.out_dim, MIN_COS[dtype])
    _assert_features(rt.encode_texts(prompts, cache=False),
                     plain.encode_texts(prompts, cache=False), rt.out_dim, MIN_COS[dtype])


@contextlib.contextmanager
def plain_fused_kernels():
    """The towers' fused and pre-split kernels replaced by their plain
    versions (same card), under the names the towers call them by."""
    from team_tpu_torch.backbone import clip
    from team_tpu_torch.ops import attention

    swaps = [(clip, "fused_attn_block", ms.attn_block_reference),
             (clip, "fused_mha_packed_proj", ms.mha_packed_proj_reference),
             (attention, "fused_mha_short", ms.mha_short_reference)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@pytest.mark.parametrize("route", ["attn_block", "mha_packed_proj", "mha_short"])
@pytest.mark.parametrize("dtype", list(MIN_COS))
def test_fused_routes_at_full_width_match_their_plain_versions(cuda_device, smoke_images,
                                                               vitb16_params, record_property,
                                                               dtype, route):
    """Both towers on the fused routes and the image tower on mha_short (the
    pre-split kernel is non-causal, one launch a block) against the same
    towers through the plain versions of their kernels."""
    images, prompts = smoke_images
    rt = _runtime(dtype, route, vitb16_params)
    batch = rt.to_device(images)
    zero_launches()
    got = {"image": rt.encode_image(batch)}
    if route == "mha_short":
        assert ms.fused_mha_short.launches == rt.clip_cfg.vision.layers
    else:
        got["text"] = rt.encode_texts(prompts, cache=False)
    record_launches(record_property)
    with plain_fused_kernels():
        want = {"image": rt.encode_image(batch)}
        if "text" in got:
            want["text"] = rt.encode_texts(prompts, cache=False)
    for name, a in got.items():
        _assert_features(a, want[name], rt.out_dim, MIN_COS[dtype])


def _plain_int8_fns(epilogues: bool = True) -> dict:
    """The plain versions of every kernel the int8 routes call, by the name
    ``quant`` calls them under (with no tensor-parallel layout registered,
    ``fused_mha_packed_q3i_tp`` runs the whole-head kernel); without
    ``epilogues``, the static epilogue kernels stay in place."""
    fns = {
        "fused_mha_packed_q3i_tp": ms.mha_packed_q3i_plain,
        "fused_mha_packed_q3i_cls": ms.mha_packed_q3i_cls_plain,
        "fused_mha_packed_q3i_cls_split": ms.mha_packed_q3i_cls_split_plain,
        "fused_mha_packed_q3i_sb": ms.mha_packed_q3i_sb_reference,
        "fused_mha_packed_q": lambda qkv, deq, oinv, h, *, seq, causal=False, kv_len=None:
            ms.mha_packed_q_reference(qkv.reshape(-1, seq, qkv.shape[-1]), deq, oinv, h, causal,
                                      kv_len).reshape(qkv.shape[0], -1),
        "fused_mha_packed_q3": lambda qkv, deq, oinv, h, *, causal=False, kv_len=None:
            ms.mha_packed_q_reference(qkv, deq, oinv, h, causal, kv_len, bf16_deq=True),
        "attention_core": lambda qkv, heads, *, causal, kv_len, impl:
            ms.mha_packed_reference(qkv, heads, causal, kv_len),
        "ln_quantize_static": im.ln_quantize_static_reference,
        "row_quant_static": im.row_quant_static_reference,
        "static_requant": im.static_requant_reference,
        "static_residual": im.static_residual_reference,
        "ln_quant_folded": im.ln_quant_folded_reference,
    }
    return fns if epilogues else {k: f for k, f in fns.items() if k not in STATIC_EPILOGUES}


def _plain_tier_fns() -> dict:
    """The plain versions of the dynamic tiers' kernels and of the packed
    attention, by the name ``quant`` calls them under."""
    return {**{name: getattr(im, name + "_reference") for name in TIER_KERNELS},
            "attention_core": lambda qkv, heads, *, causal, kv_len, impl:
                ms.mha_packed_reference(qkv, heads, causal, kv_len)}


def _swapped(fns: dict, run):
    """``run()`` with ``fns`` in place of the functions of those names in
    ``quant`` (same payload, same card)."""
    saved = {name: getattr(quant, name) for name in fns}
    for name, fn in fns.items():
        setattr(quant, name, fn)
    try:
        return run()
    finally:
        for name, fn in saved.items():
            setattr(quant, name, fn)


def _int8_kernels_on_tower_inputs(run):
    """``run()`` through the kernels, with every call of an int8 route's
    kernels held against its plain version on the same inputs, the tower's
    own activations: at most one int8 step, on under INT8_MAX_FRAC of each
    kernel's outputs; the static epilogues bit for bit without a GELU
    (``static_residual`` compared by its bf16 bits) and on under
    EPILOGUE_MAX_FRAC with one; the int8 PV to ``pv_int8_limit`` of the
    call's scales."""
    plain = _plain_int8_fns()
    stats = {}

    def checked(name, kernel):
        def call(*args, **kwargs):
            out = kernel(*args, **kwargs)
            ref = plain[name](*args, **kwargs)
            if out.dtype == torch.bfloat16:  # steps of the bf16 bit pattern
                diff = (out.view(torch.int16).int() - ref.view(torch.int16).int()).abs()
            else:
                diff = (out.int() - ref.int()).abs()
            if name == "static_residual" or (name == "static_requant"
                                             and kwargs.get("activation") is None):
                limit = 0
            elif kwargs.get("pv_int8"):
                limit = pv_int8_limit(args[1], args[3])
            else:
                limit = 1
            key = (name, kwargs.get("activation") if name == "static_requant" else None)
            worst, n_diff, n, lim = stats.get(key, (0, 0, 0, limit))
            stats[key] = (max(worst, int(diff.max().item())), n_diff + int((diff > 0).sum()),
                          n + diff.numel(), min(lim, limit))
            return out
        return call

    names = [n for n in plain if n != "attention_core"]  # the int8-output kernels
    feats = _swapped({n: checked(n, getattr(quant, n)) for n in names}, run)
    assert stats
    for (name, act), (worst, n_diff, n, limit) in stats.items():
        share = EPILOGUE_MAX_FRAC if name in STATIC_EPILOGUES else INT8_MAX_FRAC
        assert worst <= limit and n_diff < share * n, (name, act, worst, limit, n_diff / n)
    return feats


# the configurations served from the payload another run saved: name -> (the
# run whose cache it loads, int8_gemm_impl, knobs, each q3i kernel's launches
# per encode of an L-layer tower, or None)
SERVED = {
    "static3d": ("static", "static3d", {}, None),
    "static3d_qa": ("static_qa", "static3d_qa", {}, None),
    "static3d_qib": ("static3d_qi", "static3d_qib", {},
                     lambda n: {"fused_mha_packed_q3i": n - 1, "fused_mha_packed_q3i_cls": 1}),
    "static3d_qi2": ("static3d_qi", "static3d_qi2", {}, lambda n: {"fused_mha_packed_q3i": n}),
    "static3d_qi2_defer": ("static3d_qi", "static3d_qi2", {"TEAM_QI_DEFER": "1"},
                           lambda n: {"fused_mha_packed_q3i": n}),
    "mlp": ("static3d_qi", "static3d_qi", {"TEAM_CLS_LAST": "mlp"},
            lambda n: {"fused_mha_packed_q3i": n}),
    "attn": ("static3d_qi", "static3d_qi", {"TEAM_CLS_LAST": "attn"},
             lambda n: {"fused_mha_packed_q3i": n - 1}),
    "exp2i": ("static3d_qi", "static3d_qi", {"TEAM_QI_SOFTMAX": "exp2i"},
              lambda n: {"fused_mha_packed_q3i": n - 1, "fused_mha_packed_q3i_cls": 1}),
    "reduce": ("static3d_qi", "static3d_qi", {"TEAM_QI_ROWSUM": "reduce"},
               lambda n: {"fused_mha_packed_q3i": n - 1, "fused_mha_packed_q3i_cls": 1}),
    "reduce_defer": ("static3d_qi", "static3d_qi", {"TEAM_QI_ROWSUM": "reduce",
                                                    "TEAM_QI_DEFER": "1"},
                     lambda n: {"fused_mha_packed_q3i": n - 1, "fused_mha_packed_q3i_cls": 1}),
}
# every payload configuration: name -> (the run whose cache it loads,
# int8_gemm_impl, knobs, q3i launches per encode or None)
INT8_CONFIGS = {"static3d_qi": ("static3d_qi", "static3d_qi", {}, None),
                **{run: (run, route, env, None) for run, (route, env, _) in INT8_ROUTES.items()},
                **SERVED}


@pytest.mark.parametrize("name", list(INT8_CONFIGS))
def test_int8_payload_through_its_kernels_matches_the_plain_versions(cuda_device, monkeypatch,
                                                                     smoke_images, int8_runs,
                                                                     record_property, name):
    """The payload a route's run saved, loaded (no new gate) under this
    configuration's route and knobs: every int8 kernel call held against its
    plain version on the tower's own inputs (``_int8_kernels_on_tower_inputs``),
    the q3i kernels' launches in that encode exact, and the features against
    the same route with the plain versions of its kernels at cosine >=
    0.9999 and max |Δ| <= 5e-2 rms: a flipped int8 step (about one output in
    1e6) is requantized through every later block. static3d_qi is also held
    against the plain versions of its attention kernels alone (the epilogue
    kernels on both sides), where no step flips, to 5e-3 rms."""
    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime

    source, route, env, per_encode = INT8_CONFIGS[name]
    cache = int8_runs.cache(source)
    int8_runs.get(source)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    images, _ = smoke_images
    rt = BackboneRuntime(smoke_config("simplecil", "bfloat16", "", encoder_quant="int8_static",
                                      extras={"int8_cache_dir": cache, "int8_gemm_impl": route}))
    img = rt.encode_image(rt.to_device(images))
    assert rt.int8_committed and rt.gate_cosine is None, "the payload was not loaded"
    zero_launches()
    checked = _int8_kernels_on_tower_inputs(lambda: rt.encode_image(rt.to_device(images)))
    record_launches(record_property)
    if per_encode is not None:
        want = dict.fromkeys(Q3I_COUNTERS, 0)
        want.update(per_encode(rt.clip_cfg.vision.layers))
        assert {c: getattr(ms, c).launches for c in Q3I_COUNTERS} == want
    assert img.shape == (len(images), rt.out_dim) and bool(torch.isfinite(img).all())
    assert torch.equal(checked, img)
    checks = [(_plain_int8_fns(), 5e-2)]
    if name == "static3d_qi":
        checks.append((_plain_int8_fns(epilogues=False), 5e-3))
    for fns, max_rel in checks:
        plain = _swapped(fns, lambda: rt.encode_image(rt.to_device(images)))
        err, rms = (img - plain).abs().max().item(), plain.pow(2).mean().sqrt().item()
        assert _cos(img, plain) >= 0.9999 and err <= max_rel * rms, (_cos(img, plain), err, rms)


def _tier_kernels_on_tower_inputs(run):
    """``run()`` through the kernels, with every call of the dynamic tiers'
    kernels held against its plain version on the same inputs: int8 outputs
    at most one step apart on under INT8_MAX_FRAC of them, scales within
    1e-6 relative, bf16 outputs within one bf16 step (2^-7 |ref|) plus 1e-5
    of the largest |ref|."""
    plain = _plain_tier_fns()
    stats = {}

    def checked(name, kernel):
        def call(*args, **kwargs):
            out = kernel(*args, **kwargs)
            ref = plain[name](*args, **kwargs)
            outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
            st = stats.setdefault(name, {"steps": 0, "n_diff": 0, "n": 0, "scale_rel": 0.0,
                                         "bf16_ok": True})
            for o, r in zip(outs, refs):
                if o.dtype == torch.int8:
                    diff = (o.int() - r.int()).abs()
                    st["steps"] = max(st["steps"], int(diff.max().item()))
                    st["n_diff"] += int((diff > 0).sum())
                    st["n"] += diff.numel()
                elif o.dtype == torch.float32:
                    st["scale_rel"] = max(st["scale_rel"], ((o - r).abs() / r.abs()).max().item())
                else:
                    err = (o.float() - r.float()).abs()
                    limit = BF16_STEP * r.float().abs() + 1e-5 * r.float().abs().max()
                    st["bf16_ok"] &= bool((err <= limit).all())
            return out
        return call

    out = _swapped({n: checked(n, getattr(quant, n)) for n in TIER_KERNELS}, run)
    assert stats
    for name, st in stats.items():
        frac = st["n_diff"] / st["n"] if st["n"] else 0.0
        assert st["steps"] <= 1 and frac < INT8_MAX_FRAC and st["scale_rel"] <= 1e-6 \
            and st["bf16_ok"], (name, st)
    return out


def test_xla_tier_at_full_width_through_the_packed_kernel(cuda_device, smoke_images,
                                                          vitb16_params, record_property):
    """The dynamic xla tier through the library API, on the dynamic payload
    of ``quantize_vision_tower`` (the runtime gates only the static payload,
    which fails there as in team_tpu): one packed-kernel launch a block, and
    its features against the same tier with the packed kernel's plain
    version at cosine >= 0.9999."""
    from team_tpu_torch.backbone.clip import CLIPConfig
    from team_tpu_torch.bridge import tree_to
    from team_tpu_torch.ops.preprocess import preprocess_batch

    cfg = CLIPConfig.vit_b16()
    qv = quant.quantize_vision_tower(tree_to(vitb16_params, cuda_device))
    small = torch.from_numpy(smoke_images[0]).to(cuda_device)

    def encode():
        return quant.encode_image_int8(qv, preprocess_batch(small, cfg.vision.image_size), cfg,
                                       gemm_impl="xla")

    zero_launches()
    img = encode()
    record_launches(record_property)
    assert ms.fused_mha_packed.launches == cfg.vision.layers
    plain = _swapped({"attention_core": _plain_tier_fns()["attention_core"]}, encode)
    assert bool(torch.isfinite(img).all()) and _cos(img, plain) >= 0.9999, _cos(img, plain)


@pytest.mark.parametrize("tier", list(TIER_PER_BLOCK))
def test_dynamic_tiers_at_full_width_through_their_kernels(cuda_device, smoke_images,
                                                           vitb16_params, record_property, tier):
    """hybrid and pallas through the library API on the dynamic payload at
    full width: every kernel call held against its plain version on the
    tower's inputs, the kernels' launches in one encode exact, the features
    against the same tier with the plain versions at cosine >= 0.9999."""
    from team_tpu_torch.backbone.clip import CLIPConfig
    from team_tpu_torch.bridge import tree_to
    from team_tpu_torch.ops.preprocess import preprocess_batch

    cfg = CLIPConfig.vit_b16()
    qv = quant.quantize_vision_tower(tree_to(vitb16_params, cuda_device))
    small = torch.from_numpy(smoke_images[0]).to(cuda_device)

    def encode():
        return quant.encode_image_int8(qv, preprocess_batch(small, cfg.vision.image_size), cfg,
                                       gemm_impl=tier)

    zero_launches()
    img = encode()
    record_launches(record_property)
    assert {name: getattr(im, name).launches for name in TIER_KERNELS} == {
        name: cfg.vision.layers * n for name, n in TIER_PER_BLOCK[tier].items()}
    checked = _tier_kernels_on_tower_inputs(encode)
    plain = _swapped(_plain_tier_fns(), encode)
    assert bool(torch.isfinite(img).all()) and torch.equal(checked, img)
    assert _cos(img, plain) >= 0.9999, _cos(img, plain)


@pytest.mark.parametrize("route", ["xla", "hybrid", "pallas", "static3d_qi"])
def test_int8_text_tower_on_the_class_prompts(cuda_device, smoke_images, vitb16_params,
                                              record_property, route):
    """encode_text_int8 at full width on the class prompts: xla, hybrid and
    pallas on the dynamic text payload, static3d_qi on the prompt-set
    payload; each against the bf16 text tower (cosine >= 0.99) and against
    itself with the plain versions of its kernels. Against those the dynamic
    tiers and static3d_qi are held to cosine >= 0.9995, xla to 0.9999:
    ln_quantize's scales differ from its plain version's by a few ulps (its
    f32 sums run in another order), which moves the bf16 rounding of some of
    the next GEMM's outputs in a block, and 12 causal blocks carry that to
    the pooled token (0.9997708 at 8 prompts, NVIDIA H100 80GB HBM3, 700.00
    W); static3d_qi's ln_quant_folded sums in another order too, and against
    the plain versions of its attention kernels alone it is held to 0.9999.
    The dynamic tiers' launches are exact and each of their kernel calls is
    held against its plain version on the tower's own inputs."""
    from team_tpu_torch.backbone.clip import CLIPConfig, cast_frozen_params, encode_text
    from team_tpu_torch.backbone.tokenizer import Tokenizer
    from team_tpu_torch.bridge import tree_to

    cfg = CLIPConfig.vit_b16()
    tokens = torch.from_numpy(Tokenizer(require_bpe=False)(smoke_images[1])).to(cuda_device)
    p32 = tree_to(vitb16_params, cuda_device)
    bf16 = encode_text(cast_frozen_params(vitb16_params, torch.bfloat16, cuda_device), tokens, cfg,
                       compute_dtype=torch.bfloat16)
    if route == "static3d_qi":
        qt = quant.quantize_text_tower_for_prompts(p32, tokens, cfg, heads=cfg.text.heads)
    else:
        qt = quant.quantize_text_tower(p32)

    def encode():
        return quant.encode_text_int8(qt, tokens, cfg, gemm_impl=route)

    zero_launches()
    got = encode()
    record_launches(record_property)
    want = {name: cfg.text.layers * n for name, n in TIER_PER_BLOCK.get(route, {}).items()}
    if want:
        assert {name: getattr(im, name).launches for name in TIER_KERNELS} == want
        assert torch.equal(_tier_kernels_on_tower_inputs(encode), got)
    ref = _swapped({**_plain_int8_fns(), **_plain_tier_fns()}, encode)
    if route == "static3d_qi":
        attn = _swapped({**_plain_int8_fns(epilogues=False), **_plain_tier_fns()}, encode)
        assert _cos(got, attn) >= 0.9999, _cos(got, attn)
    limit = 0.9995 if want or route == "static3d_qi" else 0.9999
    assert got.shape == bf16.shape and bool(torch.isfinite(got).all())
    assert _cos(got, ref) >= limit and _cos(got, bf16) >= 0.99, (_cos(got, ref), _cos(got, bf16))


# -- the backwards, Grad-CAM ------------------------------------------------

def _fused_inputs(b, s, h, dtype, dev, seed=0, dh=64):
    """x, a layer norm's affine, the attention's weights and biases (biases and
    affine non-zero: the random init makes them 0 and 1), and a packed qkv."""
    g = torch.Generator(device=dev).manual_seed(seed)
    d = h * dh

    def randn(*shape, std=1.0, mean=0.0):
        return torch.randn(shape, generator=g, device=dev) * std + mean

    return {"x": randn(b, s, d).to(dtype), "ln": (randn(d, std=0.3, mean=1.0), randn(d, std=0.2)),
            "attn": (randn(d, 3 * d, std=d ** -0.5).to(dtype), randn(3 * d, std=0.5),
                     randn(d, d, std=d ** -0.5).to(dtype), randn(d, std=0.5)),
            "qkv": randn(b, s, 3 * d).to(dtype)}


# the gradient through a kernel's Function against autograd of its plain
# reference, as a share of the reference gradient's largest |value|: both
# backwards are the same recompute, so they differ only through the
# cotangent, which depends on the forward (kernel against plain reference)
BACKWARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _assert_grads_agree(kernel, plain, inputs: dict, dtype):
    """d/d inputs of sum(tanh(out) * w) through ``kernel`` (the wrapper, so its
    autograd Function) and through ``plain`` (autograd of the plain
    reference), within BACKWARD_TOL of the reference's largest |gradient|."""
    grads = {}
    for label, fn in (("kernel", kernel), ("plain", plain)):
        leaves = {k: t.detach().clone().requires_grad_(True) for k, t in inputs.items()}
        out = fn(**leaves)
        w = torch.randn(out.shape, generator=torch.Generator(device=out.device).manual_seed(7),
                        device=out.device)
        grads[label] = torch.autograd.grad((torch.tanh(out.float()) * w).sum(),
                                           list(leaves.values()))
    torch.cuda.synchronize()
    for key, gk, gp in zip(inputs, grads["kernel"], grads["plain"]):
        scale = gp.float().abs().max().item()
        err = (gk.float() - gp.float()).abs().max().item() / max(scale, 1e-30)
        assert math.isfinite(err) and scale > 0 and gk.dtype == gp.dtype, (key, err, scale)
        assert err <= BACKWARD_TOL[dtype], (key, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tower,b,s,h,causal", [("vision", 8, 197, 12, False),
                                                ("text", 8, 77, 8, True)])
def test_kernel_backwards_match_autograd_of_the_plain_references(cuda_device, record_property,
                                                                 tower, b, s, h, causal, dtype):
    """The autograd Functions of #1, #13, #14 and (the image tower) #3: the
    kernel's forward, a recompute of the plain attention differentiated, at
    the towers' shapes; each kernel launched once a forward."""
    inp = _fused_inputs(b, s, h, dtype, cuda_device, seed=11)
    zero_launches()
    _assert_grads_agree(lambda qkv: ms.fused_mha_packed(qkv, h, causal=causal),
                        lambda qkv: ms.mha_packed_backward_reference(qkv, h, causal),
                        {"qkv": inp["qkv"]}, dtype)
    ln, attn = inp["ln"], inp["attn"]
    block = dict(x=inp["x"], ln_scale=ln[0], ln_bias=ln[1], qkv_w=attn[0], qkv_b=attn[1],
                 out_w=attn[2], out_b=attn[3])
    _assert_grads_agree(lambda **a: ms.fused_attn_block(*a.values(), h, causal=causal),
                        lambda **a: ms.attn_block_backward_reference(*a.values(), h, causal),
                        block, dtype)
    kv_len = s if causal else s * 3 // 4
    g = torch.Generator(device=cuda_device).manual_seed(12)
    q, k, v = (torch.randn((b, h, s, 64), generator=g, device=cuda_device).to(dtype)
               for _ in range(3))
    _assert_grads_agree(lambda q, k, v: fa.flash_attention(q, k, v, kv_len, causal=causal),
                        lambda q, k, v: fa.xla_attention(q, k, v, kv_len, causal=causal),
                        {"q": q, "k": k, "v": v}, dtype)
    if not causal:
        _assert_grads_agree(lambda q, k, v: ms.fused_mha_short(q, k, v, kv_len),
                            lambda q, k, v: fa.xla_attention(q, k, v, kv_len),
                            {"q": q, "k": k, "v": v}, dtype)
    record_launches(record_property)
    assert (ms.fused_mha_packed.launches, ms.fused_attn_block.launches,
            fa.flash_attention.launches, ms.fused_mha_short.launches) == (1, 1, 1, int(not causal))


def test_mha_packed_proj_refuses_an_input_that_requires_grad(cuda_device):
    """#12 has no backward: a gradient would flow along the residual only."""
    inp = _fused_inputs(2, 77, 8, torch.bfloat16, cuda_device, seed=13)
    qkv = inp["qkv"].clone().requires_grad_(True)
    with pytest.raises(RuntimeError):
        ms.fused_mha_packed_proj(qkv, inp["attn"][2], inp["attn"][3], inp["x"], 8, causal=True)


GRADCAM_TOL = 1e-3  # Grad-CAM's [0, 1] maps on a kernel route against the plain route (f32)
GRADCAM_ROUTES = {"auto": (ms, "fused_mha_packed"), "mha_short": (ms, "fused_mha_short"),
                  "attn_block": (ms, "fused_attn_block"), "pallas": (fa, "flash_attention")}


@pytest.mark.parametrize("route", list(GRADCAM_ROUTES))
def test_gradcam_through_each_kernel_route_matches_the_plain_route(cuda_device, vitb16_params,
                                                                   record_property, route):
    """Full ViT-B/16 width, B=4 normalized images, float32: the [0, 1] maps
    within GRADCAM_TOL of the plain route's, the route's kernel launched once
    a layer (its forward; its backward is the plain recompute)."""
    from team_tpu_torch.analysis.gradcam import grad_cam
    from team_tpu_torch.backbone.clip import CLIPConfig
    from team_tpu_torch.bridge import tree_to

    cfg = CLIPConfig.vit_b16()
    params = tree_to(vitb16_params, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    size = cfg.vision.image_size
    images = torch.randn((4, size, size, 3), generator=g, device=cuda_device)
    target = torch.randn((cfg.embed_dim,), generator=g, device=cuda_device)
    want = grad_cam(params, images, target, cfg, attn_impl="xla")
    module, counter = GRADCAM_ROUTES[route]
    zero_launches()
    cam = grad_cam(params, images, target, cfg, attn_impl=route)
    torch.cuda.synchronize()
    record_launches(record_property)
    assert cam.shape == want.shape and getattr(module, counter).launches == cfg.vision.layers
    assert (cam - want).abs().max().item() <= GRADCAM_TOL


# -- data and tensor parallelism -------------------------------------------

GRAD_LIMIT = 1e-3  # of each leaf's largest gradient; a sum off by the world size is 0.5
TP_MIN_COSINE = 0.999  # bf16 row-parallel sums run in another order than one device's GEMM
PARALLEL_WORLD = 2  # ranks spawned on the one card (gloo)


def _assert_runs_agree(want: dict, got: dict) -> None:
    """Curves equal, and each epoch's loss components within 1e-3 relative
    (the bound of tests/test_multihost.py)."""
    assert got["curves"] == want["curves"] and len(got["stats"]) == len(want["stats"])
    for (t0, e0, d0), (t1, e1, d1) in zip(want["stats"], got["stats"]):
        assert (t0, e0, d0["n"]) == (t1, e1, d1["n"])
        for k in ("total", "ce", "clip", "unicl"):
            assert abs(d0[k] - d1[k]) / max(1.0, abs(d0[k])) <= 1e-3, (t0, e0, k)


def _assert_grads_as_recorded(want_path: str, got_path: str) -> None:
    """The gradients two runs pickled agree leaf by leaf within GRAD_LIMIT of
    the leaf's largest. AdamW's update does not see a gradient scaled by a
    constant, so the curves and losses alone would pass a step off by the
    world size; the gradients do not."""
    import pickle

    with open(want_path, "rb") as f:
        want = pickle.load(f)
    with open(got_path, "rb") as f:
        got = pickle.load(f)
    assert len(want) == GRAD_STEPS and len(got) == len(want)
    for gw, gg in zip(want, got):
        assert [a is None for a in gw] == [b is None for b in gg]
        for a, b in zip(gw, gg):
            if a is not None:
                assert np.abs(a - b).max() / max(float(np.abs(a).max()), 1e-12) <= GRAD_LIMIT


def test_parallel_paths_on_one_card(cuda_device, tmp_path, record_property):
    """(a) A world of one rank over NCCL: PROOF with mesh_shape [1] and [1,
    1] gives the curves of the run without a mesh. (b) Two ranks on the one
    card over gloo (``tests/torch_card_parallel_worker.py``): PROOF data
    parallel on mesh_shape [2] gives the single process's curves, losses and
    first steps' gradients; the bf16 image tower at B=128 under a [1, 2]
    layout on mha_packed_tp (one head-split launch a block) against one
    device's features at cosine >= 0.999; the int8 static3d_qi tower under
    it (q3i attention through fused_mha_packed_q3i_tp, the ranks' gates
    identical and committed)."""
    import json

    import torch.distributed as dist

    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime
    from team_tpu_torch.parallel.mesh import maybe_init_distributed

    single_grads = str(tmp_path / "nomesh_grads.pkl")
    single = train_recording(proof_config(tmp_path / "nomesh"), single_grads)
    maybe_init_distributed([0], init_method=f"file://{tmp_path / 'rdzv_world1'}", world_size=1,
                           rank=0)
    try:
        assert dist.get_backend() == "nccl"
        for shape in ([1], [1, 1]):
            _assert_runs_agree(single, train_recording(proof_config(
                tmp_path / f"mesh{len(shape)}", mesh_shape=shape,
                mesh_axis_names=["data", "model"])))
    finally:
        dist.destroy_process_group()

    out_dir = tmp_path / "parallel"
    out_dir.mkdir()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                        "MASTER_PORT")}
    worker = Path(__file__).with_name("torch_card_parallel_worker.py")
    procs = [subprocess.Popen([sys.executable, str(worker), str(r), str(PARALLEL_WORLD),
                               str(out_dir / "rdzv"), str(out_dir)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(PARALLEL_WORLD)]
    try:
        outs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-6000:]}"
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(PARALLEL_WORLD)]
    for r, res in enumerate(ranks):
        _assert_runs_agree(single, res["dp"])
        _assert_grads_as_recorded(single_grads, str(out_dir / f"dp_grads_rank{r}.pkl"))
    feats = [np.load(out_dir / f"tp_image_rank{r}.npy") for r in range(PARALLEL_WORLD)]
    assert np.array_equal(feats[0], feats[1])
    params, _ = tp_weights_and_images()
    rt = BackboneRuntime(smoke_config("simplecil", "bfloat16", ""), params=params)
    ref = rt.encode_image(rt.to_device(np.load(out_dir / "tp_images.npy"))).cpu()
    assert _cos(torch.from_numpy(feats[0]), ref) >= TP_MIN_COSINE
    gates = [(res["int8"]["gate_cosine"], res["int8"]["committed"]) for res in ranks]
    assert len(set(gates)) == 1 and gates[0][1], gates
    record_launches(record_property, {name: sum(res["launches"][name] for res in ranks)
                                      for name in ranks[0]["launches"]})
    assert all(n > 0 for res in ranks for n in res["launches"].values()), ranks


# -- the probe scripts, the library API, the loader -------------------------

def _probe_runs():
    """name -> (its run, the launch counters it must move): the probe
    scripts at their own shapes, and #26 through the library API at B=128."""
    from team_tpu_torch.ops import gemm_probe as gp
    from team_tpu_torch.ops import preprocess as pp
    from team_tpu_torch.scripts import (attn_shootout, int8_mxu_ceiling, int8_probe,
                                        r4_attn_decomp, r5_megakernel_probe)

    def normalize():
        x = torch.randint(0, 256, (EVAL_B, 224, 224, 3), device="cuda", dtype=torch.uint8)
        out = pp.normalize_uint8_kernel(x)
        assert tuple(out.shape) == tuple(x.shape)

    return {
        "attn_shootout": (lambda: (attn_shootout.main([]),
                                   attn_shootout.main(["--mode", "qpad128"])),
                          lambda: {"fused_mha_short_v2": ms.fused_mha_short_v2.launches}),
        "r4_attn_decomp": (lambda: r4_attn_decomp.main([]),
                           lambda: dict(ms.fused_mha_q3i_variant.launches)),
        "normalize": (normalize, lambda: {"normalize": pp.normalize_uint8_kernel.launches}),
        "int8_probe": (lambda: int8_probe.main([]), lambda: {"probe_mm": gp.probe_mm.launches}),
        "int8_mxu_ceiling": (lambda: int8_mxu_ceiling.main([]),
                             lambda: {"mxu_ceiling": gp.mxu_ceiling.launches}),
        "r5_megakernel_probe": (lambda: r5_megakernel_probe.main([]),
                                lambda: {"mlp_mega_2d": gp.mlp_mega_2d.launches,
                                         "mlp_mega_3d": gp.mlp_mega_3d.launches}),
    }


@pytest.mark.parametrize("probe", ["attn_shootout", "r4_attn_decomp", "normalize", "int8_probe",
                                   "int8_mxu_ceiling", "r5_megakernel_probe"])
def test_probe_entry_points_launch_their_kernels(cuda_device, record_property, probe):
    """Each entry point, with the counts zeroed just before it, launches each
    of its kernels (every #29 variant, both entries of #30); #26 once."""
    run, counts = _probe_runs()[probe]
    zero_launches()
    run()
    torch.cuda.synchronize()
    record_launches(record_property)
    got = counts()
    assert got and all(got.values()), got
    if probe == "normalize":
        assert got == {"normalize": 1}


def _openclip_shapes(cfg) -> dict:
    """The key and shape of every array that ``convert_openclip_state_dict``
    reads from an open_clip checkpoint of ``cfg``'s towers."""
    v, t = cfg.vision, cfg.text

    def blocks(prefix: str, layers: int, w: int) -> dict:
        shapes = {}
        for i in range(layers):
            p = f"{prefix}{i}."
            shapes.update({
                p + "ln_1.weight": (w,), p + "ln_1.bias": (w,),
                p + "attn.in_proj_weight": (3 * w, w), p + "attn.in_proj_bias": (3 * w,),
                p + "attn.out_proj.weight": (w, w), p + "attn.out_proj.bias": (w,),
                p + "ln_2.weight": (w,), p + "ln_2.bias": (w,),
                p + "mlp.c_fc.weight": (4 * w, w), p + "mlp.c_fc.bias": (4 * w,),
                p + "mlp.c_proj.weight": (w, 4 * w), p + "mlp.c_proj.bias": (w,)})
        return shapes

    return {
        "visual.conv1.weight": (v.width, 3, v.patch_size, v.patch_size),
        "visual.class_embedding": (v.width,),
        "visual.positional_embedding": (v.seq_len, v.width),
        "visual.ln_pre.weight": (v.width,), "visual.ln_pre.bias": (v.width,),
        **blocks("visual.transformer.resblocks.", v.layers, v.width),
        "visual.ln_post.weight": (v.width,), "visual.ln_post.bias": (v.width,),
        "visual.proj": (v.width, cfg.embed_dim),
        "token_embedding.weight": (t.vocab_size, t.width),
        "positional_embedding": (t.context_length, t.width),
        **blocks("transformer.resblocks.", t.layers, t.width),
        "ln_final.weight": (t.width,), "ln_final.bias": (t.width,),
        "text_projection": (t.width, cfg.embed_dim),
        "logit_scale": (),
    }


def _loaded_leaves(tree, sd):
    """(loaded leaf, the source array in the tree's layout) for every kind of
    entry the loader converts: the patch kernel, the embeddings, the layer
    norms and projections of both towers, every array of one block of each
    tower, logit_scale."""
    v, t = tree["vision"], tree["text"]
    conv = sd["visual.conv1.weight"]
    out = [(v["patch_w"], conv.reshape(conv.shape[0], -1).T),
           (v["cls"], sd["visual.class_embedding"]), (v["pos"], sd["visual.positional_embedding"]),
           (v["ln_pre"]["scale"], sd["visual.ln_pre.weight"]),
           (v["ln_post"]["bias"], sd["visual.ln_post.bias"]), (v["proj"], sd["visual.proj"]),
           (t["token_embedding"], sd["token_embedding.weight"]),
           (t["pos"], sd["positional_embedding"]), (t["ln_final"]["bias"], sd["ln_final.bias"]),
           (t["proj"], sd["text_projection"]), (tree["logit_scale"], sd["logit_scale"])]
    block = (("ln_1", "scale", "ln_1.weight", False), ("ln_1", "bias", "ln_1.bias", False),
             ("attn", "qkv_w", "attn.in_proj_weight", True),
             ("attn", "qkv_b", "attn.in_proj_bias", False),
             ("attn", "out_w", "attn.out_proj.weight", True),
             ("attn", "out_b", "attn.out_proj.bias", False),
             ("ln_2", "scale", "ln_2.weight", False), ("ln_2", "bias", "ln_2.bias", False),
             ("mlp", "fc_w", "mlp.c_fc.weight", True), ("mlp", "fc_b", "mlp.c_fc.bias", False),
             ("mlp", "proj_w", "mlp.c_proj.weight", True),
             ("mlp", "proj_b", "mlp.c_proj.bias", False))
    for tower, prefix in (("vision", "visual.transformer.resblocks."),
                          ("text", "transformer.resblocks.")):
        i = len(tree[tower]["blocks"]) // 2
        for sub, leaf, key, transposed in block:
            src = sd[f"{prefix}{i}.{key}"]
            out.append((tree[tower]["blocks"][i][sub][leaf], src.T if transposed else src))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, list):
        for item in tree:
            yield from _leaves(item)
    else:
        yield tree


def test_open_clip_loader_at_full_width(cuda_device, tmp_path, monkeypatch):
    """Fault 3.8's repair at full ViT-B/16 width: a seeded synthetic open_clip
    state dict saved as .npz; the loader's tree equals the source arrays
    (every kind of entry, both towers' block counts); TEAM_CLIP_CHECKPOINT
    naming the file loads it into the runtime (allow_byte_tokenizer set),
    whose tree and one encode equal the runtime given the loader's tree
    through ``params=``; without allow_byte_tokenizer the runtime raises
    FileNotFoundError (no BPE vocabulary), as team_tpu does."""
    from team_tpu_torch.backbone.clip import CLIPConfig
    from team_tpu_torch.backbone.import_weights import load_clip_checkpoint
    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime

    clip_cfg = CLIPConfig.vit_b16()
    rng = np.random.default_rng(0)
    sd = {k: (rng.standard_normal(shape) * (0.02 if len(shape) > 1 else 0.1)
              + (1.0 if k.endswith(("ln_1.weight", "ln_2.weight")) else 0.0)).astype(np.float32)
          for k, shape in _openclip_shapes(clip_cfg).items()}
    sd["logit_scale"] = np.asarray(np.log(1 / 0.07), dtype=np.float32)
    path = str(tmp_path / "openclip_synthetic.npz")
    np.savez(path, **sd)
    tree = load_clip_checkpoint(path, clip_cfg)
    assert len(tree["vision"]["blocks"]) == clip_cfg.vision.layers
    assert len(tree["text"]["blocks"]) == clip_cfg.text.layers
    assert all(leaf.dtype == torch.float32 and np.array_equal(leaf.numpy(), src)
               for leaf, src in _loaded_leaves(tree, sd))
    cfg = smoke_config("simplecil", "bfloat16", tmp_path, extras={"allow_byte_tokenizer": True})
    monkeypatch.setenv("TEAM_CLIP_CHECKPOINT", path)
    rt = BackboneRuntime(cfg)
    with pytest.raises(FileNotFoundError):
        BackboneRuntime(smoke_config("simplecil", "bfloat16", tmp_path))
    monkeypatch.delenv("TEAM_CLIP_CHECKPOINT")
    ref_rt = BackboneRuntime(cfg, params=tree)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(rt.params), _leaves(ref_rt.params)))
    images = torch.randint(0, 256, (8, 224, 224, 3), generator=torch.Generator(
        device=rt.device).manual_seed(4), device=rt.device, dtype=torch.uint8)
    feats = rt.encode_image(images)
    assert torch.equal(feats, ref_rt.encode_image(images)) and bool(torch.isfinite(feats).all())
