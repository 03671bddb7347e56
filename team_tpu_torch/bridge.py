"""Parameters across the two packages: a ``team_tpu`` params pytree (nested
dicts and lists of arrays, taken to numpy with ``np.asarray``) to the port's
tree of tensors, and back.

Leaves keep their shape, dtype and bits; weights keep the ``[in, out]``
layout, so ``x @ W`` means the same on both sides. Every parity test carries
the JAX init across with it.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

_DTYPES = (np.float32, np.float64, np.int32, np.int64, np.int8, np.uint8, np.bool_)


def params_from_numpy(tree: Any, device: Optional[torch.device] = None) -> Any:
    """Nested dicts/lists of numpy-convertible leaves -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype.type not in _DTYPES:
        raise TypeError(f"unsupported parameter dtype {arr.dtype}")
    return torch.tensor(arr, device=device)


def params_to_numpy(tree: Any) -> Any:
    """Tree of tensors -> the same tree of numpy arrays (on the host)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def tree_to(tree: Any, device: torch.device) -> Any:
    """The same tree of tensors, moved to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)
