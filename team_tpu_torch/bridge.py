"""Parameters across the two packages: a ``team_tpu`` params pytree (nested
dicts, lists and named tuples of arrays, taken to numpy with ``np.asarray``)
to the port's tree of tensors, and back.

Leaves keep their shape, dtype and bits; weights keep the ``[in, out]``
layout, so ``x @ W`` means the same on both sides. Every parity test carries
the JAX init across with it: the CLIP towers' params, PROOF's ``trainable``,
``aux`` and ``buffers``, and the heads' and DMIG's parameter dicts.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

_DTYPES = (np.float32, np.float64, np.int32, np.int64, np.int8, np.uint8, np.bool_)


def params_from_numpy(tree: Any, device: Optional[torch.device] = None) -> Any:
    """Nested dicts/lists of numpy-convertible leaves -> the same tree of
    tensors (a named tuple becomes a dict of its fields)."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype.type not in _DTYPES:
        raise TypeError(f"unsupported parameter dtype {arr.dtype}")
    return torch.tensor(arr, device=device)


# the module parameter dicts' static ints (``init_cosine_proxy_linear``'s proxies
# per class, ``init_connectivity_extractor``'s heads), which stay Python ints
STATIC_INT_KEYS = ("nb_proxy", "n_heads")


def module_params_from_numpy(tree: Any, device: Optional[torch.device] = None) -> Any:
    """The heads' and DMIG's parameter dicts (:mod:`team_tpu_torch.modules.heads`,
    :mod:`team_tpu_torch.modules.dynamic_graph`) from numpy: tensors, with
    the leaves under :data:`STATIC_INT_KEYS` as ints."""
    if isinstance(tree, dict):
        return {k: int(np.asarray(v)) if k in STATIC_INT_KEYS else
                module_params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [module_params_from_numpy(v, device) for v in tree]
    return params_from_numpy(tree, device)


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


def proof_state_from_numpy(state: Dict[str, Any], device: Optional[torch.device] = None):
    """PROOF's ``{"trainable", "aux", "buffers"}`` -> ``(trainable, aux,
    ProofBuffers)`` of tensors on ``device``."""
    from team_tpu_torch.learners.proof_net import ProofBuffers

    buffers = params_from_numpy(state["buffers"], device)
    return (params_from_numpy(state["trainable"], device), params_from_numpy(state["aux"], device),
            ProofBuffers(**buffers))


def proof_state_to_numpy(trainable: Any, aux: Any, buffers: Any) -> Dict[str, Any]:
    """The inverse of :func:`proof_state_from_numpy`, on the host."""
    return {"trainable": params_to_numpy(trainable), "aux": params_to_numpy(aux),
            "buffers": params_to_numpy(buffers._asdict())}
