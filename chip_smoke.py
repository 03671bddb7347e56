"""Smoke run of the PyTorch/CUDA port (team_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, one line or more each:
  1. the card (nvidia-smi name and power limit); TF32 off for matmuls and cuDNN
  2. build the kernels from team_tpu_torch/csrc, one nvcc per source, in
     parallel (set-up)
  3. each kernel vs its plain PyTorch version at the towers' shapes: the
     packed attention in bf16 and f32; the int8 integer-QK^T attention and
     its CLS-query variant (static and row-max softmax, causal, kv_len), at
     most one int8 step apart with under 1 % of the outputs differing
  4. kernels and plain versions timed with CUDA events (main-path shapes)
  5. the main path through team_tpu_torch.trainer.train at full ViT-B/16
     width, random init: SimpleCIL (bf16) and ZS-CLIP (f32), whose packed
     attention launches must be non-zero for causal (text) and non-causal
     (vision) calls; then SimpleCIL on the int8 static tier, which must
     commit the quantized tower (a fallback to bf16 fails) with 11 q3i and
     one q3i_cls launch per int8 batch; each path's counts are zeroed just
     before its run and read just after
  6. features against the plain-attention towers and against the bf16 tower
     on a small batch; the image-encode rates at the eval batch (bf16, f32,
     int8)
  7. a torch.profiler split of one B=128 encode, int8 and bf16
Then one JSON line of kernel results, and last the JSON status line.
Any failure raises, and the script exits non-zero without the status line.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

os.environ.setdefault("TEAM_PHASE_TIMES", "1")  # read when the phase timer is loaded

MAIN_SHAPES = {  # (batch, seq, heads, causal) of the two towers at their batch sizes
    "vision": (128, 197, 12, False),
    "text": (32, 77, 8, True),
}
TOL = {"torch.float32": 1e-5, "torch.bfloat16": 2e-2}  # as in tests/test_torch_mha_packed.py
INT8_MAX_FRAC = 0.01  # q3i kernels: at most one int8 step, and under 1 % of outputs differing
DATASET = {"num_classes": 4, "img_size": 224, "train_per_stage": 64, "test_per_stage": 32}
EVAL_B = 128  # the learners' eval batch
# the learner batch of exps/IIMinsects202.json: the int8 run calibrates on its
# first batch and gates on the second, both from one class and stage of the
# synthetic set (each class, stage and split has its own colour, so a
# calibration batch of one colour does not cover the next colour: the gate
# then falls back, in team_tpu as here)
FLAGSHIP_BATCH = 16


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare_kernel(ms, dev) -> float:
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    cases = [(*MAIN_SHAPES["vision"], None), (*MAIN_SHAPES["text"], None),
             (32, 197, 12, False, 150), (32, 77, 8, True, 60)]
    for b, s, h, causal, kv_len in cases:
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn((b, s, 3 * h * 64), generator=gen, device=dev).to(dtype)
            out = ms.fused_mha_packed(qkv, h, causal=causal, kv_len=kv_len)
            ref = ms.mha_packed_reference(qkv, h, causal, kv_len)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = TOL[str(dtype)]
            print(f"  B={b} S={s} H={h} causal={causal} kv_len={kv_len} {dtype}: "
                  f"max_abs_err={err:.3e} (tol {tol:g})")
            if not math.isfinite(err) or err > tol:
                raise AssertionError(f"kernel disagrees with its plain version: {err} > {tol}")
            worst = max(worst, err)
    return worst


def time_kernel(ms, dev) -> dict:
    import torch

    gen = torch.Generator(device=dev).manual_seed(1)
    times = {}
    for tower, (b, s, h, causal) in MAIN_SHAPES.items():
        qkv = torch.randn((b, s, 3 * h * 64), generator=gen, device=dev).to(torch.bfloat16)
        kernel = lambda: ms.fused_mha_packed(qkv, h, causal=causal)  # noqa: E731
        plain = lambda: ms.mha_packed_reference(qkv, h, causal)  # noqa: E731
        p1, k1, k2, p2 = _time_ms(plain), _time_ms(kernel), _time_ms(kernel), _time_ms(plain)
        times[tower] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"  {tower} B={b} S={s} H={h} causal={causal} bf16: kernel {k1:.4f}/{k2:.4f} ms, "
              f"plain {p1:.4f}/{p2:.4f} ms")
    return times


def q3i_inputs(b, s, heads, dev, seed=0, dh=64):
    """int8 qkv and scales in the ranges of tests/test_torch_mha_q3i.py."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    d = heads * dh

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    qkv = torch.randint(-127, 128, (b, s, 3 * d), generator=g, device=dev, dtype=torch.int8)
    return (qkv, uniform((1, 3 * d), 0.01, 0.03), uniform((1, heads), 1e-4, 3e-4) * 4 / dh ** 0.5,
            uniform((1, d), 20, 60), uniform((1, heads), 3, 6))


def _int8_disagreement(name: str, out, ref) -> int:
    diff = (out.int() - ref.int()).abs()
    worst, frac = int(diff.max().item()), (diff > 0).float().mean().item()
    print(f"  {name}: max |diff| {worst} int8 steps, {100 * frac:.4f} % of outputs differ "
          f"(limits 1, {100 * INT8_MAX_FRAC:g} %)")
    if out.shape != ref.shape or worst > 1 or frac >= INT8_MAX_FRAC:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return worst


def compare_q3i(ms, dev) -> dict:
    """Both integer-QK^T kernels against their plain versions; the CLS kernel
    also against row 0 of the full kernel."""
    worst = {"q3i": 0, "q3i_cls": 0}
    cases = [(*MAIN_SHAPES["vision"], None, True), (*MAIN_SHAPES["vision"], None, False),
             (*MAIN_SHAPES["text"], None, False), (32, 197, 12, False, 150, False),
             (32, 77, 8, True, 60, False)]
    for b, s, h, causal, kv_len, static in cases:
        qkv, deq, qks, oinv, m2 = q3i_inputs(b, s, h, dev)
        m2 = m2 if static else None
        out = ms.fused_mha_packed_q3i(qkv, deq, qks, oinv, h, causal=causal, kv_len=kv_len, qk_m2=m2)
        ref = ms.mha_packed_q3i_reference(qkv, deq, qks, oinv, h, causal, kv_len, m2)
        torch_sync()
        name = f"q3i B={b} S={s} H={h} causal={causal} kv_len={kv_len} static={static}"
        worst["q3i"] = max(worst["q3i"], _int8_disagreement(name, out, ref))
    b, s, h, _ = MAIN_SHAPES["vision"]
    for static in (True, False):
        qkv, deq, qks, oinv, m2 = q3i_inputs(b, s, h, dev, seed=1)
        m2 = m2 if static else None
        out = ms.fused_mha_packed_q3i_cls(qkv, deq, qks, oinv, h, qk_m2=m2)
        ref = ms.mha_packed_q3i_reference(qkv, deq, qks, oinv, h, qk_m2=m2, rows=1)
        full = ms.fused_mha_packed_q3i(qkv, deq, qks, oinv, h, qk_m2=m2)[:, :1].contiguous()
        torch_sync()
        name = f"q3i_cls B={b} S={s} H={h} static={static}"
        worst["q3i_cls"] = max(worst["q3i_cls"], _int8_disagreement(name + " vs plain", out, ref),
                               _int8_disagreement(name + " vs full kernel row 0", out, full))
    return worst


def time_q3i(ms, dev) -> dict:
    """Both integer-QK^T kernels at the vision shape, static softmax (the main path's form)."""
    b, s, h, _ = MAIN_SHAPES["vision"]
    qkv, deq, qks, oinv, m2 = q3i_inputs(b, s, h, dev, seed=2)
    pairs = {
        "q3i": (lambda: ms.fused_mha_packed_q3i(qkv, deq, qks, oinv, h, qk_m2=m2),
                lambda: ms.mha_packed_q3i_reference(qkv, deq, qks, oinv, h, qk_m2=m2)),
        "q3i_cls": (lambda: ms.fused_mha_packed_q3i_cls(qkv, deq, qks, oinv, h, qk_m2=m2),
                    lambda: ms.mha_packed_q3i_reference(qkv, deq, qks, oinv, h, qk_m2=m2, rows=1)),
    }
    times = {}
    for name, (kernel, plain) in pairs.items():
        p1, k1, k2, p2 = _time_ms(plain), _time_ms(kernel), _time_ms(kernel), _time_ms(plain)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"  {name} B={b} S={s} H={h} int8, static softmax: kernel {k1:.4f}/{k2:.4f} ms, "
              f"plain {p1:.4f}/{p2:.4f} ms")
    return times


def torch_sync() -> None:
    import torch

    torch.cuda.synchronize()


def smoke_config(model_name: str, dtype: str, log_dir: str, **kw):
    from team_tpu_torch.config import Config

    extras = {"tiny_backbone": False, "dataset_kwargs": dict(DATASET), **kw.pop("extras", {})}
    return Config(prefix="chip_smoke", dataset="synthetic_insects", model_name=model_name,
                  convnet_type="clip", init_cls=2, increment=2, batch_size=kw.pop("batch_size", 128),
                  seed=[1], shuffle=True, device=[0], compute_dtype=dtype, log_dir=log_dir,
                  extras=extras, **kw)


@contextlib.contextmanager
def recording_runtimes():
    """Collect the BackboneRuntime instances the trainer builds."""
    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime

    made, init = [], BackboneRuntime.__init__

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    BackboneRuntime.__init__ = recording_init
    try:
        yield made
    finally:
        BackboneRuntime.__init__ = init


def run_main_path(ms, log_dir: str) -> dict:
    """SimpleCIL (bf16) then ZS-CLIP (f32) through the trainer; launch counts
    are zeroed right before each run and read right after it."""
    from team_tpu_torch.trainer import train
    from team_tpu_torch.utils import phase_timer

    counts = {"launches": 0, "causal": 0}
    for model_name, dtype in (("simplecil", "bfloat16"), ("zs_clip", "float32")):
        phase_timer.reset()
        ms.reset_launch_counts()
        t0 = time.perf_counter()
        res = train(smoke_config(model_name, dtype, os.path.join(log_dir, model_name)))
        wall = time.perf_counter() - t0
        launches, causal = ms.fused_mha_packed.launches, ms.fused_mha_packed.causal_launches
        print(f"  {model_name} ({dtype}): {wall:.2f} s, top1 per task {[float(a) for a in res['cnn_top1']]}, "
              f"top4 {[float(a) for a in res['cnn_top5']]}; kernel launches {launches} "
              f"(causal {causal}, non-causal {launches - causal})")
        for line in phase_timer.format_report().splitlines():
            print("    " + line)
        if causal == 0 or launches - causal == 0:
            raise AssertionError(f"{model_name}: the main path did not launch the kernel for "
                                 "both towers")
        accs = list(res["cnn_top1"]) + list(res["cnn_top5"])
        if len(res["cnn_top1"]) != 2 or not all(0.0 <= float(a) <= 100.0 for a in accs):
            raise AssertionError(f"{model_name}: bad accuracy curve {res}")
        counts["launches"] += launches
        counts["causal"] += causal
    return counts


def run_int8_path(ms, log_dir: str, cache_dir: str) -> dict:
    """SimpleCIL (bf16) on the int8 static tier through the trainer: it must
    commit the quantized tower, and every int8 batch runs the integer-QK^T
    kernel in 11 blocks and the CLS kernel in the last."""
    from team_tpu_torch.trainer import train
    from team_tpu_torch.utils import phase_timer

    cfg = smoke_config("simplecil", "bfloat16", os.path.join(log_dir, "simplecil_int8"),
                       batch_size=FLAGSHIP_BATCH, encoder_quant="int8_static",
                       extras={"int8_cache_dir": cache_dir})
    phase_timer.reset()
    with recording_runtimes() as made:
        ms.reset_launch_counts()
        t0 = time.perf_counter()
        res = train(cfg)
        wall = time.perf_counter() - t0
        q3i, cls = ms.fused_mha_packed_q3i.launches, ms.fused_mha_packed_q3i_cls.launches
        packed = ms.fused_mha_packed.launches
    print(f"  simplecil (int8_static, batch {FLAGSHIP_BATCH}): {wall:.2f} s, top1 per task {[float(a) for a in res['cnn_top1']]}, "
          f"top4 {[float(a) for a in res['cnn_top5']]}; launches q3i {q3i}, q3i_cls {cls}, "
          f"packed bf16 {packed} (calibration, gate and text)")
    for line in phase_timer.format_report().splitlines():
        print("    " + line)
    if len(made) != 1:
        raise AssertionError(f"expected one backbone runtime, got {len(made)}")
    rt = made[0]
    print(f"  held-out gate: min cosine {rt.gate_cosine} (limit 0.999); committed {rt.int8_committed}")
    if not rt.int8_committed or rt.encoder_quant != "int8_static":
        raise AssertionError("the int8 path fell back to bf16: the quantized tower was not committed")
    layers = rt.clip_cfg.vision.layers
    if cls == 0 or q3i != (layers - 1) * cls:
        raise AssertionError(f"int8 launches: q3i {q3i}, q3i_cls {cls}; want {layers - 1} and 1 "
                             "per int8 batch, both non-zero")
    accs = list(res["cnn_top1"]) + list(res["cnn_top5"])
    if len(res["cnn_top1"]) != 2 or not all(0.0 <= float(a) <= 100.0 for a in accs):
        raise AssertionError(f"simplecil int8: bad accuracy curve {res}")
    return {"q3i": q3i, "q3i_cls": cls, "gate_cosine": rt.gate_cosine}


def _encode_rate(rt, images, n: int = 10) -> float:
    import torch

    batch = rt.to_device(_eval_batch(images))
    rt.encode_image(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        rt.encode_image(batch)
    torch.cuda.synchronize()
    return n * EVAL_B / (time.perf_counter() - t0)


def _eval_batch(images):
    import numpy as np

    return np.stack([images[i % len(images)] for i in range(EVAL_B)])


def check_features(dev, cache_dir: str) -> dict:
    """The kernel-path towers against the plain-attention towers (same random
    weights) on a small batch of the smoke dataset; the int8 tower, loaded
    from the main path's cache, against the bf16 tower; and the encode rates."""
    import numpy as np
    import torch

    from team_tpu_torch.data import DataManager
    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime

    dm = DataManager("synthetic_insects", True, 1, 2, 2, **DATASET)
    images = np.stack(dm.get_dataset(np.arange(4), source="test", mode="test").images[:8])
    prompts = [t.format(c) for c in dm._class_to_label for t in dm._data_to_prompt]
    rates = {}
    bf16_img = None
    for dtype, min_cos in (("float32", 0.99999), ("bfloat16", 0.99)):
        cfg = smoke_config("simplecil", dtype, "")
        rt = BackboneRuntime(cfg)
        img = rt.encode_image(rt.to_device(images))
        txt = rt.encode_texts(prompts, cache=False)
        cfg.attention_impl = "xla"
        plain = BackboneRuntime(cfg)
        img_ref = plain.encode_image(plain.to_device(images))
        txt_ref = plain.encode_texts(prompts, cache=False)
        for name, a, b in (("image", img, img_ref), ("text", txt, txt_ref)):
            if a.shape != (len(b), rt.out_dim) or not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{dtype} {name} features: shape {tuple(a.shape)} or not finite")
            cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
            err = (a - b).abs().max().item()
            print(f"  {dtype} {name} features vs plain attention: min cosine {cos:.7f} "
                  f"(limit {min_cos}), max abs diff {err:.3e}")
            if cos < min_cos:
                raise AssertionError(f"{dtype} {name} features disagree with the plain tower")
        if dtype == "bfloat16":
            bf16_img = img
        rates[dtype] = _encode_rate(rt, images)
        print(f"  encode {dtype}: {rates[dtype]:.1f} img/s (B={EVAL_B}, 224x224 uint8 in, "
              f"ViT-B/16 image tower)")
    cfg = smoke_config("simplecil", "bfloat16", "", encoder_quant="int8_static",
                       extras={"int8_cache_dir": cache_dir})
    rt = BackboneRuntime(cfg)
    img = rt.encode_image(rt.to_device(images))
    if not rt.int8_committed or rt.gate_cosine is not None:
        raise AssertionError("the int8 runtime did not load the main path's validated payload")
    plain = _int8_plain_attention(rt, images)
    cos = torch.nn.functional.cosine_similarity(img, plain, dim=-1).min().item()
    err, rms = (img - plain).abs().max().item(), plain.pow(2).mean().sqrt().item()
    print(f"  int8 image features (payload loaded from the cache) vs the int8 tower with plain "
          f"attention: min cosine {cos:.7f} (limit 0.9999), max abs diff {err:.3e} "
          f"(limit {5e-3 * rms:.3e} = 5e-3 rms)")
    if img.shape != bf16_img.shape or not bool(torch.isfinite(img).all()) or cos < 0.9999 \
            or err > 5e-3 * rms:
        raise AssertionError("int8 features through the kernels disagree with plain attention")
    cos_bf16 = torch.nn.functional.cosine_similarity(img, bf16_img, dim=-1).min().item()
    print(f"  int8 vs bf16 tower on these test images (other colours than the calibration "
          f"batch): min cosine {cos_bf16:.7f}")
    rates["int8_static"] = _encode_rate(rt, images)
    print(f"  encode int8_static: {rates['int8_static']:.1f} img/s (B={EVAL_B}, 224x224 uint8 in, "
          f"ViT-B/16 image tower)")
    return rates, rt


def _int8_plain_attention(rt, images):
    """The int8 tower's features with the plain attention versions in place
    of both kernels (same payload, same card)."""
    from team_tpu_torch.backbone import quant
    from team_tpu_torch.ops import mha_short as ms

    saved = quant.fused_mha_packed_q3i, quant.fused_mha_packed_q3i_cls
    quant.fused_mha_packed_q3i = (lambda qkv, deq, qks, oinv, h, qk_m2=None, **kw:
                                  ms.mha_packed_q3i_reference(qkv, deq, qks, oinv, h, qk_m2=qk_m2))
    quant.fused_mha_packed_q3i_cls = (lambda qkv, deq, qks, oinv, h, qk_m2=None:
                                      ms.mha_packed_q3i_reference(qkv, deq, qks, oinv, h,
                                                                  qk_m2=qk_m2, rows=1))
    try:
        return rt.encode_image(rt.to_device(images))
    finally:
        quant.fused_mha_packed_q3i, quant.fused_mha_packed_q3i_cls = saved


def _kernel_group(name: str) -> str:
    if "q3i_kernel" in name or "mha_packed_kernel" in name:
        return "attention kernels"
    low = name.lower()
    if "gemm" in low or "nvjet" in low or "cutlass" in low or "xmma" in low:
        return "GEMMs"
    return "elementwise and other"


def profile_encodes(rt_int8, dev) -> None:
    """torch.profiler device time of one B=128 encode, int8 and bf16, by kernel."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime

    rt_bf16 = BackboneRuntime(smoke_config("simplecil", "bfloat16", ""))
    size = rt_int8.clip_cfg.vision.image_size
    u8 = np.random.default_rng(0).integers(0, 256, (EVAL_B, size, size, 3), dtype=np.uint8)
    for name, rt in (("int8_static", rt_int8), ("bfloat16", rt_bf16)):
        batch = rt.to_device(u8)
        rt.encode_image(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rt.encode_image(batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        total = sum(e.self_device_time_total for e in kernels) / 1e3
        print(f"  {name}: one B={EVAL_B} encode, wall {1e3 * wall:.2f} ms, device kernel time "
              f"{total:.2f} ms")
        if not kernels:
            print("    (the trace holds no device time)")
            continue
        groups = defaultdict(float)
        for e in kernels:
            groups[_kernel_group(e.key)] += e.self_device_time_total / 1e3
        for group, ms_ in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"    {group}: {ms_:.3f} ms ({100 * ms_ / total:.1f} %)")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"    {e.self_device_time_total / 1e3:8.3f} ms  {e.count:4d}x  {e.key[:110]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    try:
        from team_tpu_torch.ops import _build
        from team_tpu_torch.ops import mha_short as ms
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the repository root",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    print("phase 1: card")
    print(_card())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off for matmul and cuDNN")

    print("phase 2: build (one nvcc per source, in parallel)")
    t0 = time.perf_counter()
    ms.build()
    print(f"  mha_packed.cu and mha_packed_q3i.cu built and loaded in {time.perf_counter() - t0:.2f} s")
    for source in ("mha_packed.cu", "mha_packed_q3i.cu"):
        for line in _build.BUILD_LOGS.get(source, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {source}: " + line.strip())

    print("phase 3: kernels vs plain versions")
    max_err = compare_kernel(ms, dev)
    q3i_err = compare_q3i(ms, dev)

    print("phase 4: timing (CUDA events, 20 launches after 3 warm-up; plain, kernel, kernel, plain)")
    times = time_kernel(ms, dev)
    times.update(time_q3i(ms, dev))

    print("phase 5: main path")
    with tempfile.TemporaryDirectory() as log_dir:
        counts = run_main_path(ms, log_dir)
        int8 = run_int8_path(ms, log_dir, os.path.join(log_dir, "int8_cache"))
        print("phase 6: features and encode rates")
        rates, rt_int8 = check_features(dev, os.path.join(log_dir, "int8_cache"))
    print("phase 7: profile of one encode")
    profile_encodes(rt_int8, dev)

    q3i_common = {"route": "cuda", "source": "team_tpu_torch/csrc/mha_packed_q3i.cu"}
    print(json.dumps({"kernels": [{
        "name": "fused_mha_packed", "route": "cuda",
        "source": "team_tpu_torch/csrc/mha_packed.cu",
        "replaces": "team_tpu/ops/mha_short.py:135",
        "launches": counts["launches"], "causal_launches": counts["causal"],
        "max_abs_err": max_err,
        "ms": times["vision"][0], "plain_ms": times["vision"][1],
        "text_ms": times["text"][0], "text_plain_ms": times["text"][1],
        "encode_img_per_s": rates,
    }, {
        "name": "fused_mha_packed_q3i", **q3i_common,
        "replaces": "team_tpu/ops/mha_short.py:477",
        "launches": int8["q3i"], "max_abs_err": q3i_err["q3i"],
        "ms": times["q3i"][0], "plain_ms": times["q3i"][1],
        "gate_cosine": int8["gate_cosine"],
    }, {
        "name": "fused_mha_packed_q3i_cls", **q3i_common,
        "replaces": "team_tpu/ops/mha_short.py:663",
        "launches": int8["q3i_cls"], "max_abs_err": q3i_err["q3i_cls"],
        "ms": times["q3i_cls"][0], "plain_ms": times["q3i_cls"][1],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
