"""What the card tests share: the learners' configurations at full ViT-B/16
width, the recording of a trainer's objects, the int8 PV's limit, and the
kernels' launch counts, which each path test zeroes before its run and
records after it as its ``launches`` property (``chip_smoke.py`` reads them
from the JUnit report). Imported by ``tests/test_torch_card_paths.py``,
``tests/test_torch_cuda.py``, ``tests/test_torch_siglip_cuda.py`` and the
parallel worker; it imports the port only, never jax."""

import contextlib
import json
import math

import numpy as np
import torch

DATASET = {"num_classes": 4, "img_size": 224, "train_per_stage": 64, "test_per_stage": 32}
EVAL_B = 128  # the learners' eval batch
# the learner batch of exps/IIMinsects202.json: the int8 run calibrates on its
# first batch and gates on the second, both from one class and stage of the
# synthetic set (each class, stage and split has its own colour, so a
# calibration batch of one colour does not cover the next colour: the gate
# then falls back, in team_tpu as here)
FLAGSHIP_BATCH = 16
GRAD_STEPS = 2  # steps whose gradients the data-parallel check holds


def smoke_config(model_name: str, dtype: str, log_dir: str, **kw):
    from team_tpu_torch.config import Config

    extras = {"tiny_backbone": False, "dataset_kwargs": dict(DATASET), **kw.pop("extras", {})}
    return Config(prefix="card_paths", dataset="synthetic_insects", model_name=model_name,
                  convnet_type=kw.pop("convnet_type", "clip"), init_cls=2, increment=2,
                  batch_size=kw.pop("batch_size", 128), seed=[1], shuffle=True,
                  device=kw.pop("device", [0]), compute_dtype=dtype, log_dir=str(log_dir),
                  extras=extras, **kw)


def proof_config(log_dir, **kw):
    return smoke_config("proof", "bfloat16", log_dir, batch_size=FLAGSHIP_BATCH, tuned_epoch=2,
                        **kw)


@contextlib.contextmanager
def recording(cls, setup=None):
    """Collect the instances of ``cls`` the trainer builds (``setup(instance)``
    runs on each as it is made)."""
    made, init = [], cls.__init__

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        if setup is not None:
            setup(self)
        made.append(self)

    cls.__init__ = recording_init
    try:
        yield made
    finally:
        cls.__init__ = init


def train_recording(cfg, grads_path: str = "") -> dict:
    """One PROOF run through the trainer: its curves and each epoch's loss
    stats. With ``grads_path``, the gradients the optimizer takes in the
    first GRAD_STEPS steps (summed over the ranks under a data group) are
    pickled there, one list of leaves (None: no gradient) a step."""
    import pickle

    from team_tpu_torch.learners import proof as proof_learner
    from team_tpu_torch.learners.proof_net import trainable_leaves
    from team_tpu_torch.trainer import train

    losses, grads, step = [], [], proof_learner.train_step

    def record(learner):
        learner._epoch_stats_hook = lambda task, epoch, st: losses.append(
            [task, epoch, {k: float(v) for k, v in st.items()}])

    def recorded(tr, *a, **k):
        st = step(tr, *a, **k)
        if len(grads) < GRAD_STEPS:
            grads.append([None if p.grad is None else p.grad.detach().float().cpu().numpy()
                          for p in trainable_leaves(tr)])
        return st

    if grads_path:
        proof_learner.train_step = recorded
    try:
        with recording(proof_learner.Learner, record):
            res = train(cfg)
    finally:
        proof_learner.train_step = step
    if grads_path:
        with open(grads_path, "wb") as f:
            pickle.dump(grads, f)
    return {"curves": [float(a) for a in res["cnn_top1"]], "stats": losses}


def tp_weights_and_images():
    """The full-width towers' random weights (seed 0) and a B=128 batch of
    the synthetic set's test images (uint8, 224²), the same in every process."""
    from team_tpu_torch.backbone.clip import CLIPConfig, init_clip_params
    from team_tpu_torch.data import DataManager

    dm = DataManager("synthetic_insects", True, 1, 2, 2, **DATASET)
    images = np.stack(dm.get_dataset(np.arange(4), source="test", mode="test").images[:8])
    batch = np.stack([images[i % len(images)] for i in range(EVAL_B)])
    return init_clip_params(torch.Generator().manual_seed(0), CLIPConfig.vit_b16()), batch


def pv_int8_limit(deq, oinv) -> int:
    """The int8 PV's bound in int8 steps: one step, plus what one p8 = rint(p·127)
    that lands on the other side of a rounding edge (p's sum taken in another
    order) moves an output by, |v8|·(deq_v·o_inv)/127 <= deq_v·o_inv."""
    d = oinv.numel()
    return 1 + math.ceil((deq.reshape(-1)[2 * d:] * oinv.reshape(-1)).max().item())


def _counted_modules():
    from team_tpu_torch.ops import flash_attention, gemm_probe, int8_matmul, mha_short, tower_bf16

    return flash_attention, gemm_probe, int8_matmul, mha_short, tower_bf16


def zero_launches() -> None:
    """Every kernel wrapper's launch counts to 0."""
    from team_tpu_torch.ops import preprocess

    for module in _counted_modules():
        module.reset_launch_counts()
    preprocess.normalize_uint8_kernel.launches = 0


def launch_counts() -> dict:
    """The non-zero launch counts of every kernel wrapper: its name (the
    causal and second-kernel counts under ``<name>.causal`` and
    ``<name>.proj``, #29's under ``<name>[<variant>]``) -> launches."""
    from team_tpu_torch.ops import preprocess

    counts = {}
    for module in (*_counted_modules(), preprocess):
        for fn in vars(module).values():
            if not callable(fn) or not hasattr(fn, "launches"):
                continue
            name = fn.__name__
            if isinstance(fn.launches, dict):
                counts.update({f"{name}[{k}]": n for k, n in fn.launches.items()})
            else:
                counts[name] = fn.launches
            for attr, tag in (("causal_launches", "causal"), ("proj_launches", "proj")):
                if hasattr(fn, attr):
                    counts[f"{name}.{tag}"] = getattr(fn, attr)
    return {name: int(n) for name, n in sorted(counts.items()) if n}


def record_launches(record_property, counts=None) -> None:
    """The test's launch counts (``launch_counts()`` unless given) as its
    ``launches`` property, a JSON object."""
    record_property("launches", json.dumps(launch_counts() if counts is None else counts))
