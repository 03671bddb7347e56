"""Which device each rank runs on, and which collectives backend that
layout takes: one process per device, from the config's ``device`` and the
launcher's local layout (torchrun's ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``)."""

from __future__ import annotations

import logging
import os
from typing import Any, List, Sequence, Tuple

import torch


def local_layout() -> Tuple[int, int]:
    """``(local rank, processes on this host)``: torchrun's ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE``, else ``RANK`` and ``WORLD_SIZE``, else one process."""
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    return (int(os.environ.get("LOCAL_RANK", rank)),
            int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def _one_device(device: Any) -> torch.device:
    if isinstance(device, int) or str(device).isdigit():
        return torch.device("cuda", int(device))
    return torch.device(device)


def rank_devices(device: Any, local_world: int) -> List[torch.device]:
    """The device of each of this host's ``local_world`` ranks, from the
    config's ``device`` (``[0]``, ``0``, ``"cuda:1"``, ``["cpu"]``, ``[0, 1]``):
    a list with one entry per rank gives each rank its entry (``[0, 0]``: two
    ranks share card 0); one CUDA entry under several ranks gives rank i
    ``cuda:i``; ``cpu`` gives every rank the CPU. One process given several
    devices runs on the first: team_tpu ignores the list and takes its
    parallelism from ``mesh_shape`` alone (``team_tpu/config.py:168-169``)."""
    entries = list(device) if isinstance(device, (list, tuple)) else [device]
    devs = [_one_device(d) for d in entries]
    if local_world == 1:
        if len(devs) > 1:
            logging.info("device=%s names %d devices; one process runs on the first, %s "
                         "(parallelism comes from mesh_shape and the launched ranks)",
                         entries, len(devs), devs[0])
        return devs[:1]
    if len(devs) == local_world:
        return devs
    if len(devs) == 1:
        if devs[0].type == "cpu":
            return devs * local_world
        return [torch.device("cuda", i) for i in range(local_world)]
    raise ValueError(f"device={entries}: {local_world} ranks on this host need one device or "
                     "one per rank")


def resolve_device(device: Any) -> torch.device:
    """This rank's ``torch.device`` from the config's ``device`` (see
    :func:`rank_devices`). A CUDA device raises when CUDA is absent or the
    card does not exist: the CPU is used only when asked for by name."""
    local_rank, local_world = local_layout()
    dev = rank_devices(device, local_world)[local_rank]
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available; "
                               "pass device 'cpu' to run on the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {dev} requested but only {torch.cuda.device_count()} "
                               "card(s) exist; give one device per rank (e.g. 0,0 to share "
                               "card 0)")
    return dev


def backend_for(devices: Sequence[torch.device]) -> str:
    """The backend for ranks on ``devices`` (one per rank of this host):
    ``nccl`` when each rank has a card of its own, else ``gloo``."""
    if all(d.type == "cuda" for d in devices) and len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"
