"""Task-loop trainer.

Counterpart of ``team_tpu/trainer.py``: seed loop, logging, DataManager,
then per task ``incremental_train`` -> ``eval_task`` -> ``after_task`` (and,
for PROOF, the state-distance update and, under ``enable_plots``, the
distance-matrix plot), the top-1 and top-"5" curves, the running average and
``metrics.jsonl``. The ``topk=4`` metric is reported as "top5", as the
reference does. Under ``torchrun`` (or a process group joined before) every
rank runs the protocol on its device, the learners split their work over the
ranks by ``mesh_shape``, and only rank 0 logs and writes ``metrics.jsonl``,
as team_tpu's process 0 does. With ``checkpoint_dir`` each finished task
is saved (:mod:`team_tpu_torch.checkpoint`; rank 0 writes, then every rank
waits at a barrier), after the plot and before ``metrics.jsonl``, as
team_tpu does; with ``resume`` every rank restores the newest file and the
loop goes on from the next task:

    torchrun --nproc_per_node 2 -m team_tpu_torch.main --config cfg.json  # "mesh_shape": [2]
"""

from __future__ import annotations

import copy
import json
import logging
import time
from typing import Any, Dict, List, Optional

from team_tpu_torch.analysis.profiler import trace
from team_tpu_torch.backbone.clip import Params
from team_tpu_torch.checkpoint import TaskCheckpointer
from team_tpu_torch.config import Config
from team_tpu_torch.data import DataManager
from team_tpu_torch.learners.factory import get_model
from team_tpu_torch.parallel import collectives
from team_tpu_torch.parallel.layout import resolve_device
from team_tpu_torch.parallel.mesh import maybe_init_distributed
from team_tpu_torch.utils.phase_timer import phase
from team_tpu_torch.utils.toolkit import (
    count_parameters, describe_devices, set_random, setup_logging, world_rank)


def train(cfg: Config, clip_params: Optional[Params] = None,
          proof_state: Optional[Dict[str, Any]] = None) -> Dict[str, List[float]]:
    """Run the protocol once per seed. Returns the last seed's curves, plus
    ``"per_seed"`` with every seed's result when there are several.
    ``clip_params``: the towers' float32 parameters; ``proof_state``: PROOF's
    initial ``{"trainable", "aux", "buffers"}`` (random inits when absent)."""
    seed_list = copy.deepcopy(cfg.seed)
    if not isinstance(seed_list, (list, tuple)):
        seed_list = [seed_list]
    result: Dict = {}
    per_seed: Dict = {}
    for seed in seed_list:
        run_cfg = copy.deepcopy(cfg)
        run_cfg.seed = [seed]
        result = _train(run_cfg, clip_params, proof_state)
        per_seed[int(seed)] = result
    if len(per_seed) > 1:
        result = dict(result)
        result["per_seed"] = per_seed
    return result


def _train(cfg: Config, clip_params: Optional[Params],
           proof_state: Optional[Dict[str, Any]]) -> Dict[str, List[float]]:
    maybe_init_distributed(cfg.device)
    logs_name = setup_logging(cfg)
    set_random(cfg.seed[0])
    describe_devices(resolve_device(cfg.device), collectives.describe())
    for key, value in cfg.to_dict().items():
        logging.info("%s: %s", key, value)

    data_manager = DataManager(
        cfg.dataset, cfg.shuffle, cfg.seed[0], cfg.init_cls, cfg.increment,
        data_root=cfg.data_root, **cfg.get("dataset_kwargs", {}) or {},
    )
    logging.info("dataset: %s", cfg.dataset)
    logging.info("total classes: %d", data_manager.get_total_classnum())
    logging.info("tasks: %d", data_manager.nb_tasks)

    model = get_model(cfg.model_name, cfg, clip_params, proof_state)
    model.save_dir = logs_name

    cnn_curve: Dict[str, List[float]] = {"top1": [], "top5": []}
    nme_curve: Dict[str, List[float]] = {"top1": [], "top5": []}
    checkpointer = None
    if cfg.checkpoint_dir:
        # every rank restores from the one file rank 0 saved
        checkpointer = TaskCheckpointer(cfg.checkpoint_dir)
        if cfg.resume:
            restored = checkpointer.restore_latest(model, cnn_curve, nme_curve)
            if restored is not None:
                logging.info("resumed from task %d", restored)

    avg_acc = 0.0
    if cnn_curve["top1"]:
        avg_acc = sum(cnn_curve["top1"]) / len(cnn_curve["top1"])
    for task in range(model._cur_task + 1, data_manager.nb_tasks):
        logging.info("=" * 50)
        logging.info("task %d/%d", task + 1, data_manager.nb_tasks)
        if getattr(model, "trainable", None) is not None:
            logging.info("total params: %d", count_parameters(model.trainable))
        start_time = time.time()

        with trace(cfg.profile_dir, name=f"task_{task}"):
            with phase("incremental_train"):
                model.incremental_train(data_manager)
        with phase("eval_task"):
            cnn_accy, nme_accy, zs_seen, zs_unseen, zs_harmonic, zs_total = model.eval_task()
        with phase("after_task"):
            model.after_task()
        if hasattr(model, "update_state_distance_matrix"):
            logging.info("updating state distance matrix...")
            with phase("distance_matrix"):
                model.update_state_distance_matrix(data_manager)

        elapsed = time.time() - start_time
        logging.info("task %d took %.2fs", task + 1, elapsed)
        logging.info("CNN grouped: %s", cnn_accy["grouped"])
        logging.info("zero-shot seen/unseen/harmonic/total: %s/%s/%s/%s",
                     zs_seen, zs_unseen, zs_harmonic, zs_total)

        cnn_curve["top1"].append(cnn_accy["top1"])
        cnn_curve["top5"].append(cnn_accy["top4"])  # top4 reported as top5
        if nme_accy is not None:
            nme_curve["top1"].append(nme_accy["top1"])
            nme_curve["top5"].append(nme_accy["top4"])

        logging.info("CNN top1 curve: %s", cnn_curve["top1"])
        logging.info("CNN top5 curve: %s", cnn_curve["top5"])
        avg_acc = sum(cnn_curve["top1"]) / len(cnn_curve["top1"])
        logging.info("average accuracy: %.4f", avg_acc)

        if world_rank() == 0 and cfg.enable_plots and hasattr(model, "state_distance"):
            try:
                from team_tpu_torch.analysis.plots import visualize_distance_matrix

                visualize_distance_matrix(model.state_distance,
                                          f"{logs_name}/task{task}_state_distance.png")
            except Exception as e:  # a plot never stops training
                logging.error("distance-matrix visualization failed: %s", e)

        if checkpointer is not None:  # the task's state is complete on every rank
            if world_rank() == 0:
                checkpointer.save(task, model, cnn_curve, nme_curve)
            collectives.barrier()

        if world_rank() != 0:  # rank 0 writes the run's files
            continue

        # machine-readable metrics stream (one JSON object per task)
        with open(f"{logs_name}/metrics.jsonl", "a", encoding="utf-8") as f:
            f.write(json.dumps({
                "task": task,
                "seconds": round(elapsed, 2),
                "top1": float(cnn_accy["top1"]),
                "top4_as_top5": float(cnn_accy["top4"]),
                "grouped": {k: float(v) for k, v in cnn_accy["grouped"].items()},
                "nme_top1": float(nme_accy["top1"]) if nme_accy else None,
                "zs_seen": float(zs_seen), "zs_unseen": float(zs_unseen),
                "zs_harmonic": float(zs_harmonic), "zs_total": float(zs_total),
                "avg_acc": float(avg_acc),
            }) + "\n")

    logging.info("=" * 50)
    logging.info("final CNN top1 curve: %s", cnn_curve["top1"])
    logging.info("final average accuracy: %.4f", avg_acc)
    return {"cnn_top1": cnn_curve["top1"], "cnn_top5": cnn_curve["top5"],
            "avg_acc": [avg_acc], "nme_top1": nme_curve["top1"]}
