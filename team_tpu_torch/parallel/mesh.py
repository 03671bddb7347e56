"""Process-group mesh and sharding helpers (counterpart of
``team_tpu/parallel/mesh.py``).

team_tpu runs one controller over a JAX mesh of devices; the port runs one
process per device, in PyTorch's idiom: :func:`maybe_init_distributed` joins
the ``torch.distributed`` process group (from its arguments or from what
``torchrun`` sets), :func:`make_mesh` lays the ranks out on a ``("data",)``
or ``("data", "model")`` mesh (``torch.distributed.device_mesh``), and
:class:`MeshContext` holds this rank's place on it with the groups of its
axes. A JAX process is a rank here: ``host_shard_indices`` and the shard
gathers split work over ranks. Each counterpart computes across the group
what its team_tpu function computes across the mesh.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves, tree_map

from team_tpu_torch.parallel import collectives
from team_tpu_torch.parallel.layout import backend_for, local_layout, rank_devices, resolve_device

AXES = ("data", "model")


def maybe_init_distributed(device: Any = (0,), init_method: Optional[str] = None,
                           world_size: Optional[int] = None, rank: Optional[int] = None) -> bool:
    """Join the process group once: from ``init_method`` (``file://...`` or
    ``tcp://host:port``), ``world_size`` and ``rank``, or from the
    ``RANK``/``WORLD_SIZE``/``MASTER_ADDR`` that ``torchrun`` sets. The backend
    comes from this host's layout of the config's ``device`` over its ranks
    (:func:`backend_for`). Returns whether a group is joined (a
    single process with neither gets none, as team_tpu's ``coordinator=None``)."""
    if collectives.joined():
        return True
    if init_method is None:
        if "MASTER_ADDR" not in os.environ or "WORLD_SIZE" not in os.environ:
            return False
        init_method = "env://"
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    _, local_world = local_layout()
    backend = backend_for(rank_devices(device, local_world))
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    collectives.record_layout(backend, dev)
    logging.info("joined the process group: %s", collectives.describe())
    return True


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data",), device: Any = (0,)) -> "MeshContext":
    """Lay the ranks out on a mesh of ``shape`` (``None``: every rank on the
    data axis), rank-major as team_tpu reshapes its device list. A second
    axis is the model axis; names missing from ``axis_names`` are taken from
    ``("data", "model")``. The mesh's size must be the world's: each rank is
    one device."""
    world = collectives.group_size()
    shape = (world,) if shape is None else tuple(int(n) for n in shape)
    if len(shape) not in (1, 2):
        raise ValueError(f"mesh_shape={list(shape)}: a mesh has the axes ('data',) or "
                         "('data', 'model')")
    if math.prod(shape) != world:
        raise ValueError(f"mesh_shape={list(shape)} needs {math.prod(shape)} ranks, the world "
                         f"has {world}: launch one process per device (torchrun "
                         f"--nproc_per_node {math.prod(shape)})")
    names = tuple(axis_names)[:len(shape)]
    names = names + AXES[len(names):len(shape)]
    dev = resolve_device(device)
    device_mesh = None
    if collectives.joined():
        from torch.distributed.device_mesh import init_device_mesh

        # NCCL groups live on the cards; gloo's on the host
        mesh_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        device_mesh = init_device_mesh(mesh_type, shape, mesh_dim_names=names)
    return MeshContext(shape, names, dev, device_mesh)


@dataclasses.dataclass
class MeshContext:
    """This rank's place on the mesh and the groups of its axes.

    ``data_group`` / ``model_group`` are ``None`` when the axis has one rank
    (or no process group is joined): the collectives are then the identity.
    """

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device
    device_mesh: Any = None

    def _axis(self, name: str) -> Optional[int]:
        return self.axis_names.index(name) if name in self.axis_names else None

    def _size(self, name: str) -> int:
        i = self._axis(name)
        return 1 if i is None else self.shape[i]

    def _rank(self, name: str) -> int:
        if self._size(name) == 1:
            return 0
        return self.device_mesh.get_local_rank(name)

    def _group(self, name: str):
        return None if self._size(name) == 1 else self.device_mesh.get_group(name)

    @property
    def data_axis(self) -> str:
        return self.axis_names[0]

    @property
    def n_data(self) -> int:
        return self._size(self.data_axis)

    @property
    def data_rank(self) -> int:
        return self._rank(self.data_axis)

    @property
    def data_group(self):
        return self._group(self.data_axis)

    @property
    def n_model(self) -> int:
        return self._size("model")

    @property
    def model_rank(self) -> int:
        return self._rank("model")

    @property
    def model_group(self):
        return self._group("model")

    def data_rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n`` split over the data axis
        (``n`` a multiple of its size): the ``P(data)`` shard."""
        if n % self.n_data:
            raise ValueError(f"a batch of {n} does not split over {self.n_data} data ranks")
        per = n // self.n_data
        return slice(self.data_rank * per, (self.data_rank + 1) * per)

    def shard_batch(self, tree):
        """This rank's shard of a host batch (dict, list or array leaves with
        one leading size), padded first to a multiple of the data axis with
        repeated samples (a batch smaller than the axis included), on this
        rank's device; returns ``(shard, valid_count)`` as team_tpu's."""
        valid = np.asarray(tree_leaves(tree)[0]).shape[0]
        rows = self.data_rows(valid + (-valid) % self.n_data)

        def put(x):
            return torch.as_tensor(np.asarray(pad_rows(x, self.n_data))[rows]).to(self.device)

        return tree_map(put, tree), valid

    def replicate(self, tree):
        """The tree on this rank's device, with rank 0's values on every rank
        (every rank holds the same values by deterministic orchestration; the
        broadcast makes it so whatever each rank started from)."""
        def put(x):
            return collectives.broadcast(torch.as_tensor(x).to(self.device))

        return tree_map(put, tree)

    def shard_stacked(self, tree):
        """This rank's columns of stacked ``[K, B, ...]`` batches (B split over
        the data axis), on this rank's device."""
        def put(x):
            x = torch.as_tensor(x)
            return x[:, self.data_rows(x.shape[1])].to(self.device)

        return tree_map(put, tree)


def pad_rows(x, n_data: int):
    """Pad a batch's leading axis to a multiple of ``n_data`` by repeating its
    samples in order (``mesh.py:67-88``: tiled, so a batch smaller than the
    axis is padded too)."""
    x = np.asarray(x)
    n = x.shape[0]
    rem = (-n) % n_data
    if not rem:
        return x
    reps = np.tile(np.arange(n), -(-rem // n))[:rem]
    return np.concatenate([x, x[reps]], axis=0)


def host_shard_indices(n: int, host_id: Optional[int] = None,
                       host_count: Optional[int] = None) -> np.ndarray:
    """Rank ``i`` of ``H`` owns rows ``i, i+H, i+2H, ...`` of ``n`` (balanced,
    order-stable, no coordination); the defaults are this rank and the
    world."""
    host_id = collectives.group_rank() if host_id is None else host_id
    host_count = collectives.group_size() if host_count is None else host_count
    return np.arange(host_id, n, host_count)


def gather_host_shards(per_host_chunks: Sequence[np.ndarray], n: int) -> np.ndarray:
    """Reassemble rank-sharded rows (``per_host_chunks[h]`` holds the rows
    ``host_shard_indices(n, h, H)``) into dataset order."""
    host_count = len(per_host_chunks)
    first = per_host_chunks[0]
    out = np.empty((n,) + first.shape[1:], dtype=first.dtype)
    for h, chunk in enumerate(per_host_chunks):
        out[host_shard_indices(n, h, host_count)] = chunk
    return out


def allgather_host_shards(local: np.ndarray, n: int) -> np.ndarray:
    """Every rank's shard (its rows ``host_shard_indices(n)``) gathered into
    the full ``[n, ...]`` array in dataset order on every rank. Shards are
    padded to one length for the collective."""
    host_count = collectives.group_size()
    if host_count == 1:
        return local
    per = -(-n // host_count)
    padded = np.zeros((per,) + local.shape[1:], local.dtype)
    padded[: len(local)] = local
    parts = collectives.all_gather_list(torch.from_numpy(padded))
    chunks = [parts[h].cpu().numpy()[: len(host_shard_indices(n, h, host_count))]
              for h in range(host_count)]
    return gather_host_shards(chunks, n)


def _rank_block(x: torch.Tensor, dim: int, rank: int, nm: int) -> torch.Tensor:
    size = x.shape[dim] // nm
    return x.narrow(dim, rank * size, size).clone()


def shard_clip_params(params, mesh: MeshContext):
    """The towers' tensor-parallel layout for this rank (``mesh.py:190-224``):
    it keeps its block of the columns of ``qkv_w`` and ``fc_w`` and of the
    rows of ``out_w`` and ``proj_w`` (the model axis's ``P(None, model)`` and
    ``P(model, None)``); everything else stays whole. The towers' routing
    (``backbone/clip.py``) slices the matching bias columns itself."""
    rank, nm = mesh.model_rank, mesh.n_model
    if nm == 1:
        return params

    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, key) for v in tree]
        if tree.dim() < 2:
            return tree
        if key in ("qkv_w", "fc_w"):
            if tree.shape[1] % nm:
                raise ValueError(f"{key} {tuple(tree.shape)} does not split over {nm} ranks")
            return _rank_block(tree, 1, rank, nm)
        if key in ("out_w", "proj_w"):
            if tree.shape[0] % nm:
                raise ValueError(f"{key} {tuple(tree.shape)} does not split over {nm} ranks")
            return _rank_block(tree, 0, rank, nm)
        return tree

    return walk(params)
