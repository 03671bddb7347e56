"""Metric and utility helpers.

Counterpart of ``team_tpu/utils/toolkit.py`` (which imports jax, so the
numpy metrics are repeated here unchanged), plus the log line that
replaces ``team_tpu/parallel/mesh.py:describe_devices``.
"""

from __future__ import annotations

import logging
import os
import random
import sys
from datetime import datetime
from typing import Any, Dict

import numpy as np
import torch


def accuracy(y_pred: np.ndarray, y_true: np.ndarray, nb_old: int, increment: int = 10) -> Dict[str, float]:
    """Grouped CIL accuracy: total, per ``increment``-class group, old, new and
    harmonic, in percent rounded to 2 decimals."""
    y_pred = np.asarray(y_pred)
    y_true = np.asarray(y_true)
    if len(y_pred) != len(y_true):
        raise ValueError("Data length error.")
    all_acc: Dict[str, float] = {}
    all_acc["total"] = np.around((y_pred == y_true).sum() * 100 / len(y_true), decimals=2)

    for class_id in range(0, int(np.max(y_true)), increment):
        idxes = np.where(np.logical_and(y_true >= class_id, y_true < class_id + increment))[0]
        label = "{}-{}".format(str(class_id).rjust(2, "0"), str(class_id + increment - 1).rjust(2, "0"))
        all_acc[label] = np.around((y_pred[idxes] == y_true[idxes]).sum() * 100 / len(idxes), decimals=2)

    idxes = np.where(y_true < nb_old)[0]
    all_acc["old"] = (
        0 if len(idxes) == 0
        else np.around((y_pred[idxes] == y_true[idxes]).sum() * 100 / len(idxes), decimals=2)
    )
    idxes = np.where(y_true >= nb_old)[0]
    all_acc["new"] = (
        0 if len(idxes) == 0
        else np.around((y_pred[idxes] == y_true[idxes]).sum() * 100 / len(idxes), decimals=2)
    )
    denom = all_acc["old"] + all_acc["new"]
    all_acc["harmonic"] = (
        0.0 if denom == 0 else np.around(2 * all_acc["old"] * all_acc["new"] / denom, decimals=2)
    )
    return all_acc


def topk_accuracy(topk_pred: np.ndarray, y_true: np.ndarray) -> float:
    """Top-k accuracy from a ``[N, k]`` prediction matrix."""
    correct = sum(1 for i in range(len(y_true)) if y_true[i] in topk_pred[i])
    return float(np.around(correct * 100.0 / len(y_true), decimals=2))


def count_parameters(params: Any) -> int:
    """Number of elements in a tree (dicts, lists) of tensors or an ``nn.Module``."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(count_parameters(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_parameters(v) for v in params)
    return int(params.numel())


def tensor2numpy(x) -> np.ndarray:
    """A tensor (on any device, with or without grad), array or list -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def target2onehot(targets, n_classes: int) -> np.ndarray:
    """Int targets -> a float32 one-hot matrix ``[N, n_classes]``."""
    targets = tensor2numpy(targets)
    onehot = np.zeros((targets.shape[0], n_classes), dtype=np.float32)
    onehot[np.arange(targets.shape[0]), targets.astype(int)] = 1.0
    return onehot


def split_images_labels(imgs):
    """An ImageFolder-style ``[(path, label), ...]`` list -> (paths, labels) arrays."""
    return np.array([item[0] for item in imgs]), np.array([item[1] for item in imgs])


def set_random(seed: int = 1) -> None:
    """Seed numpy, python and torch's default generators."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def setup_logging(cfg) -> str:
    """Timestamped file+stdout logging; returns the run's log directory. Under
    several ranks only rank 0 writes the log file and logs below WARNING, as
    team_tpu's process 0 does."""
    init_cls = 0 if cfg.init_cls == cfg.increment else cfg.init_cls
    logs_name = os.path.join(cfg.log_dir, cfg.model_name, cfg.dataset, str(init_cls), str(cfg.increment))
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
    if world_rank() != 0:
        logging.basicConfig(level=logging.WARNING, format="%(asctime)s [%(filename)s] => %(message)s",
                            handlers=[logging.StreamHandler(sys.stdout)])
        return logs_name
    os.makedirs(logs_name, exist_ok=True)
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    seed = cfg.seed[0] if isinstance(cfg.seed, (list, tuple)) else cfg.seed
    logfilename = os.path.join(
        logs_name, "{}_{}_{}_{}".format(cfg.prefix, seed, cfg.convnet_type, timestamp)
    )
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s [%(filename)s] => %(message)s",
        handlers=[
            logging.FileHandler(filename=logfilename + ".log"),
            logging.StreamHandler(sys.stdout),
        ],
    )
    return logs_name


def world_rank() -> int:
    """This process's rank in the joined process group (0 when there is none)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def describe_devices(device: torch.device, layout: str = "") -> str:
    """One log line: this rank's device and ``layout`` (the world, the
    collectives' backend and their transport, when ranks are joined)."""
    if device.type == "cuda":
        txt = (f"{torch.cuda.device_count()} device(s): cuda, running on {device} "
               f"({torch.cuda.get_device_name(device)})")
    else:
        txt = f"running on {device}"
    if layout:
        txt += "; " + layout
    logging.info(txt)
    return txt
