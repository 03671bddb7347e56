"""Per-task checkpoint and resume (counterpart of ``team_tpu/checkpoint.py``).

After every task the trainer saves the learner's state and the accuracy
curves in one ``torch.save`` file, ``task_{k}.pt``; ``restore_latest`` puts
the newest one back into a fresh learner, and the task loop goes on from the
next task. A resumed run gives the curves of the run that was not
interrupted.

The file holds tensors, ints, floats, strings and lists only (in dicts), so
``torch.load(weights_only=True)`` reads it and loading runs no code from
the file (ROADMAP fault 3.11). What it holds mirrors team_tpu's Orbax tree:
the task, the known and total classes, the curves and NME curves, PROOF's
``trainable``, ``aux`` and ``buffers``, the state-distance factors, the
fix-mode ``_evo_projectors``, SimpleCIL's ``fc`` and the rehearsal memory.
Where team_tpu keeps its PRNG key, the port keeps the states of PROOF's two
generators (its init and its fusion dropout).

On restore ``_proto_mask_any`` is cleared, so that PROOF recomputes it from
the restored ``proto_mask``; team_tpu keeps the flag of the learner it
restores into (ROADMAP fault 3.6).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from team_tpu_torch.bridge import tree_to


def _to_host(tree: Any) -> Any:
    """A tree of tensors (dicts, lists, named tuples) as detached CPU tensors."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    return tree.detach().cpu().clone()


def _array_record(a: np.ndarray) -> Any:
    """A memory array as the file holds it: a tensor, or a list of strings
    for paths."""
    a = np.asarray(a)
    return a.astype(str).tolist() if a.dtype.kind in "USO" else torch.from_numpy(a.copy())


def _array_from_record(r: Any) -> np.ndarray:
    return np.asarray(r) if isinstance(r, list) else r.numpy()


class TaskCheckpointer:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, task: int) -> str:
        return os.path.join(self.directory, f"task_{task}.pt")

    def save(self, task: int, model, curves: Dict[str, List[float]],
             nme_curves: Optional[Dict[str, List[float]]] = None) -> str:
        """Write ``task``'s file: the learner's state once the task is done
        (after ``after_task`` and the distance update) and the curves so far."""
        state: Dict[str, Any] = {
            "task": int(task),
            "known_classes": int(model._known_classes),
            "total_classes": int(model._total_classes),
            "curves": {k: [float(x) for x in v] for k, v in curves.items()},
        }
        if nme_curves is not None and any(len(v) for v in nme_curves.values()):
            state["nme_curves"] = {k: [float(x) for x in v] for k, v in nme_curves.items()}
        if getattr(model, "trainable", None) is not None:
            state["trainable"] = _to_host(model.trainable)
            state["aux"] = _to_host(model.aux)
            state["buffers"] = _to_host(model.buffers)
            state["state_distance"] = _to_host(model.state_distance.distance_factors)
        generators = {name: getattr(model, attr) for name, attr in
                      (("init", "_init_gen"), ("dropout", "_dropout_gen"))
                      if getattr(model, attr, None) is not None}
        if generators:
            state["generators"] = {name: {"state": g.get_state(), "device": str(g.device)}
                                   for name, g in generators.items()}
        if getattr(model, "_evo_projectors", None) is not None:
            state["evo_projectors"] = _to_host(model._evo_projectors)
        if getattr(model, "fc", None) is not None:
            state["fc"] = _to_host(model.fc)
        if len(model._data_memory):
            state["memory"] = {"data": _array_record(model._data_memory),
                               "targets": _array_record(model._targets_memory),
                               "stages": _array_record(model._stages_memory)}
        path = self._path(task)
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)  # a reader never sees half a file
        logging.info("checkpoint saved: %s", path)
        return path

    def latest_task(self) -> Optional[int]:
        tasks = []
        for name in os.listdir(self.directory):
            stem, ext = os.path.splitext(name)
            if ext == ".pt" and stem.startswith("task_") and stem[5:].isdigit():
                tasks.append(int(stem[5:]))
        return max(tasks) if tasks else None

    def load(self, task: int) -> Dict[str, Any]:
        """``task``'s file, read with ``weights_only=True``."""
        return torch.load(self._path(task), map_location="cpu", weights_only=True)

    def restore_latest(self, model, curves: Dict[str, List[float]],
                       nme_curves: Optional[Dict[str, List[float]]] = None) -> Optional[int]:
        """Put the newest file's state into ``model`` and ``curves`` (and
        ``nme_curves``); returns its task, or None when there is no file."""
        task = self.latest_task()
        if task is None:
            return None
        state = self.load(task)
        model._cur_task = int(state["task"])
        model._known_classes = int(state["total_classes"])  # after_task had run
        model._total_classes = int(state["total_classes"])
        for k, v in state["curves"].items():
            curves[k] = list(v)
        if nme_curves is not None:
            for k, v in state.get("nme_curves", {}).items():
                nme_curves[k] = list(v)
        device = getattr(model, "device", None)
        if device is None:
            device = model.backbone.device if hasattr(model, "backbone") else torch.device("cpu")
        if "trainable" in state:
            from team_tpu_torch.learners.proof_net import ProofBuffers

            model.trainable = tree_to(state["trainable"], device)
            model.aux = tree_to(state["aux"], device)
            model.buffers = ProofBuffers(**tree_to(state["buffers"], device))
            model.state_distance.distance_factors = state["state_distance"]
            model._proto_mask_any = None  # recomputed from the restored proto_mask
        for name, rec in state.get("generators", {}).items():
            gen = getattr(model, f"_{name}_gen", None)
            if gen is None:
                continue
            if str(gen.device) != rec["device"]:
                logging.warning("checkpoint: the %s generator was saved on %s, this learner's "
                                "is on %s; it keeps its own state", name, rec["device"],
                                gen.device)
                continue
            gen.set_state(rec["state"])
        if "evo_projectors" in state:
            model._evo_projectors = tree_to(state["evo_projectors"], device)
        if "fc" in state:
            model.fc = tree_to(state["fc"], device)
        if "memory" in state:
            model._data_memory = _array_from_record(state["memory"]["data"])
            model._targets_memory = _array_from_record(state["memory"]["targets"])
            model._stages_memory = _array_from_record(state["memory"]["stages"])
        logging.info("checkpoint restored: %s", self._path(task))
        return task
