"""The full protocol at the flagship's shape, one learner at a time, with its
accuracy curve pinned to a golden of this port's own (counterpart of
``scripts/tpu_full_protocol.py``).

IIMinsects202's protocol on synthetic data: 20 classes at 224², 16 train and
4 test images per stage, two classes a task (ten tasks), 20 epochs, batch
16, memory 120, AdamW at 0.004, the ViT-B/16 towers in bf16 from a random
init (seed 42). ``exps/IIMinsects202.json`` fixes ``model_name: proof``, so
this is how ``simplecil`` and ``zs_clip`` run at that shape:

    python -m team_tpu_torch.scripts.full_protocol                  # card 0
    TEAM_MODEL=simplecil python -m team_tpu_torch.scripts.full_protocol
    TEAM_ENCODER_QUANT=int8_static python -m team_tpu_torch.scripts.full_protocol
    TEAM_PHASE_TIMES=1 ...                                          # the phase report
    TEAM_PIN=regen ...                          # rewrite the golden (say why in the commit)
    python -m team_tpu_torch.scripts.full_protocol --device cpu --tiny   # a quick CPU run

``TEAM_MODEL`` is ``proof`` (default), ``simplecil`` or ``zs_clip``;
``TEAM_ENCODER_QUANT`` ``bf16`` (default) or ``int8_static``;
``TEAM_PATCH_MAJOR=0`` ships images as pixels instead of the ViT's
patch-major uint8 layout.

The run fails below its learning floor (average top-1: proof 20 %,
simplecil 6 %, zs_clip 0 %, the last being chance with random weights).
Then its curve must equal, exactly, the golden
``goldens/h100_protocol_{model}_{tier}.json`` beside this file, which holds
the curve, the average and the card (``nvidia-smi``'s name and power limit)
it came from. Accuracies are percentages rounded to two decimals and the
port's card runs repeat to the bit, so any drift is a numerics change. A
missing golden fails too (team_tpu's runner writes one and passes):
``TEAM_PIN=regen`` writes it, ``TEAM_PIN=0`` skips the pin. The goldens of
the TPU package (``scripts/goldens/``) are never the yardstick: its matmul
precision differs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

from team_tpu_torch.config import Config
from team_tpu_torch.trainer import train
from team_tpu_torch.utils import phase_timer

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
FLOORS = {"proof": 20.0, "simplecil": 6.0, "zs_clip": 0.0}
# the CPU run of --tiny: the tiny backbone, 6 classes at 32² (three tasks), 2 epochs
TINY = {"memory_size": 12, "tuned_epoch": 2, "batch_size": 8,
        "context_prompt_length_per_task": 3,
        "dataset_kwargs": {"num_classes": 6, "img_size": 32, "train_per_stage": 8,
                           "test_per_stage": 4}}


def protocol_config(model: str = "proof", tier: str = "bf16", patch_major: bool = True,
                    device: Sequence[Any] = (0,), log_dir: str = "logs/full_protocol",
                    tiny: bool = False) -> Config:
    """``scripts/tpu_full_protocol.py``'s configuration (its ``:39-51``), on
    ``device``; ``tiny`` cuts it to :data:`TINY` for a quick CPU run."""
    dataset_kwargs = {"num_classes": 20, "img_size": 224, "train_per_stage": 16,
                      "test_per_stage": 4}
    kw = dict(memory_size=120, tuned_epoch=20, batch_size=16, context_prompt_length_per_task=10)
    extras: Dict[str, Any] = {"patch_major_io": patch_major}
    if tiny:
        kw.update({k: v for k, v in TINY.items() if k != "dataset_kwargs"})
        dataset_kwargs = dict(TINY["dataset_kwargs"])
        extras["tiny_backbone"] = True
    extras["dataset_kwargs"] = dataset_kwargs
    return Config(prefix="tpu_full", dataset="synthetic_insects", model_name=model,
                  convnet_type="clip", init_cls=2, increment=2, init_lr=0.004, optimizer="adam",
                  seed=[42], shuffle=True, compute_dtype="bfloat16", log_dir=log_dir,
                  encoder_quant=tier, device=list(device), extras=extras, **kw)


def card_label(device: Sequence[Any]) -> str:
    """``nvidia-smi``'s name and power limit of the run's card; ``cpu``."""
    if device[0] == "cpu":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", str(device[0])], capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip().splitlines()[0]


def golden_path(model: str, tier: str, golden_dir: str = GOLDEN_DIR) -> str:
    return os.path.join(golden_dir, f"h100_protocol_{model}_{tier}.json")


def pin_curve(curve, avg: float, model: str, tier: str, card: str,
              golden_dir: str = GOLDEN_DIR, pin: Optional[str] = None) -> str:
    """Hold the curve to its golden; returns what was done. ``pin`` (default
    ``TEAM_PIN``, else ``1``): ``1`` compares and fails on a drift or a
    missing golden, ``regen`` writes the golden, ``0`` skips."""
    pin = os.environ.get("TEAM_PIN", "1") if pin is None else pin
    path = golden_path(model, tier, golden_dir)
    record = {"model": model, "encoder_quant": tier, "cnn_top1": [float(a) for a in curve],
              "avg": round(float(avg), 4), "card": card}
    if pin == "0":
        return "not pinned (TEAM_PIN=0)"
    if pin == "regen":
        os.makedirs(golden_dir, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
        return f"golden written: {path}"
    if pin != "1":
        raise ValueError(f"TEAM_PIN must be 1, regen or 0, got {pin!r}")
    if not os.path.exists(path):
        raise AssertionError(f"no golden {path}: run once with TEAM_PIN=regen to write it")
    with open(path, encoding="utf-8") as f:
        golden = json.load(f)
    if golden["cnn_top1"] != record["cnn_top1"] or golden["avg"] != record["avg"]:
        raise AssertionError(
            f"curve drift against the golden {path} (taken on {golden.get('card')}):\n"
            f"  golden: {golden['cnn_top1']} avg {golden['avg']}\n"
            f"  run:    {record['cnn_top1']} avg {record['avg']} on {card}\n"
            "If the numerics changed on purpose, rerun with TEAM_PIN=regen and say why in the "
            "commit message.")
    return f"golden pin OK ({path})"


def run(cfg: Config, golden_dir: str = GOLDEN_DIR, pin: Optional[str] = None) -> Dict[str, Any]:
    """Train ``cfg`` through the trainer, check the floor, then the pin."""
    model, tier = cfg.model_name, cfg.encoder_quant
    card = card_label(cfg.device)
    phase_timer.reset()
    t0 = time.time()
    res = train(cfg)
    wall = time.time() - t0
    if phase_timer.ENABLED:
        print("--- phase attribution (TEAM_PHASE_TIMES=1) ---")
        print(phase_timer.format_report())
    curve = [float(a) for a in res["cnn_top1"]]
    avg = float(np.mean(res["avg_acc"]))
    print(f"full protocol [{model}/{tier}] on {card}: done in {wall:.1f} s")
    print("top1 curve:", curve)
    print("avg:", avg)
    floor = FLOORS[model]
    if not avg >= floor or not all(0.0 <= a <= 100.0 for a in curve):
        raise AssertionError(f"{model} avg {avg} fell below the {floor} % floor (curve {curve})")
    print(f"learning floor (>= {floor} % avg) OK")
    status = pin_curve(curve, avg, model, tier, card, golden_dir, pin)
    print(status)
    return {"curve": curve, "avg": avg, "wall_s": wall, "card": card, "pin": status,
            "phases": phase_timer.report()}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="0", help="a CUDA device index (default 0) or cpu")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny backbone and 6 classes at 32², for a quick CPU run")
    ap.add_argument("--golden-dir", default=GOLDEN_DIR)
    ap.add_argument("--log-dir", default="logs/full_protocol")
    args = ap.parse_args(argv)
    device = ["cpu"] if args.device == "cpu" else [int(args.device)]
    cfg = protocol_config(os.environ.get("TEAM_MODEL", "proof"),
                          os.environ.get("TEAM_ENCODER_QUANT", "bf16"),
                          os.environ.get("TEAM_PATCH_MAJOR", "1") == "1", device,
                          args.log_dir, args.tiny)
    return run(cfg, args.golden_dir)


if __name__ == "__main__":
    main()
