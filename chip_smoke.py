"""Smoke run of the PyTorch/CUDA port (team_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, one line or more each:
  1. the card (nvidia-smi name and power limit); TF32 off for matmuls and cuDNN
  2. build the packed-attention kernel from team_tpu_torch/csrc (set-up)
  3. kernel vs its plain PyTorch version at the towers' shapes, bf16 and f32
  4. kernel and plain version timed with CUDA events (bf16, main-path shapes)
  5. the main path: SimpleCIL (bf16) and ZS-CLIP (f32) through
     team_tpu_torch.trainer.train at full ViT-B/16 width, random init; the
     kernel's launch counts over that run must be non-zero for causal (text)
     and non-causal (vision) calls; features agree with the plain-attention
     tower on a small batch; the tower's encode rate at the eval batch.
Then one JSON line of kernel results, and last the JSON status line.
Any failure raises, and the script exits non-zero without the status line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

os.environ.setdefault("TEAM_PHASE_TIMES", "1")  # read when the phase timer is loaded

MAIN_SHAPES = {  # (batch, seq, heads, causal) of the two towers at their batch sizes
    "vision": (128, 197, 12, False),
    "text": (32, 77, 8, True),
}
TOL = {"torch.float32": 1e-5, "torch.bfloat16": 2e-2}  # as in tests/test_torch_mha_packed.py
DATASET = {"num_classes": 4, "img_size": 224, "train_per_stage": 64, "test_per_stage": 32}


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


def smoke_config(model_name: str, dtype: str, log_dir: str):
    from team_tpu_torch.config import Config

    return Config(prefix="chip_smoke", dataset="synthetic_insects", model_name=model_name,
                  convnet_type="clip", init_cls=2, increment=2, batch_size=128, seed=[1],
                  shuffle=True, device=[0], compute_dtype=dtype, log_dir=log_dir,
                  extras={"tiny_backbone": False, "dataset_kwargs": dict(DATASET)})


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


def check_features(dev) -> dict:
    """The kernel-path towers against the plain-attention towers (same random
    weights) on a small batch of the smoke dataset; and the encode rate."""
    import numpy as np
    import torch

    from team_tpu_torch.data import DataManager
    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime

    dm = DataManager("synthetic_insects", True, 1, 2, 2, **DATASET)
    images = np.stack(dm.get_dataset(np.arange(4), source="test", mode="test").images[:8])
    prompts = [t.format(c) for c in dm._class_to_label for t in dm._data_to_prompt]
    rates = {}
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
        batch = rt.to_device(np.stack([images[i % len(images)] for i in range(128)]))
        n = 10
        rt.encode_image(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            rt.encode_image(batch)
        torch.cuda.synchronize()
        rates[dtype] = n * 128 / (time.perf_counter() - t0)
        print(f"  encode {dtype}: {rates[dtype]:.1f} img/s (B=128, 224x224 uint8 in, "
              f"ViT-B/16 image tower)")
    return rates


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

    print("phase 2: build")
    t0 = time.perf_counter()
    ms.build()
    print(f"  mha_packed.cu built and loaded in {time.perf_counter() - t0:.2f} s")
    for line in _build.BUILD_LOGS.get("mha_packed.cu", "").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas: " + line.strip())

    print("phase 3: kernel vs plain version")
    max_err = compare_kernel(ms, dev)

    print("phase 4: timing (CUDA events, 20 launches after 3 warm-up; plain, kernel, kernel, plain)")
    times = time_kernel(ms, dev)

    print("phase 5: main path")
    with tempfile.TemporaryDirectory() as log_dir:
        counts = run_main_path(ms, log_dir)
    rates = check_features(dev)

    print(json.dumps({"kernels": [{
        "name": "fused_mha_packed", "route": "cuda",
        "source": "team_tpu_torch/csrc/mha_packed.cu",
        "replaces": "team_tpu/ops/mha_short.py:135",
        "launches": counts["launches"], "causal_launches": counts["causal"],
        "max_abs_err": max_err,
        "ms": times["vision"][0], "plain_ms": times["vision"][1],
        "text_ms": times["text"][0], "text_plain_ms": times["text"][1],
        "encode_img_per_s": rates,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
