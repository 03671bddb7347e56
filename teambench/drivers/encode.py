"""The ``encode`` driver: B-image batches through ``BackboneRuntime.encode_image``.

The learners' feature encode (``team_tpu_torch/learners/backbone_runtime.py``).
Set-up draws the weights (:mod:`teambench.weights`) and the image pool
(:mod:`teambench.traffic`) from the seed on the device, builds the runtime
from the configuration's ``runtime`` keys, and calibrates and gates an int8
tower on two pool batches. A step is one ``encode_image`` call on the next
pool batch; its output is the ``[B, embed_dim]`` features.

The check compares sampled outputs with the plain reference
(:mod:`teambench.reference.clip`) by the configuration's ``check.number``,
and, on a card, the share of the tower's math that ran in kernels of
another precision than the configuration states (kernel families'
``operands``), read from the traced window or from one profiled step after
the window. An int8 configuration also fails where its tower did not commit.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from teambench import trace as tracing
from teambench import traffic as gen
from teambench import weights, work
from teambench.manifest import off_precision_share
from teambench.reference import clip as reference

MISSING = 1e30  # the gap of a row that is missing or not finite (JSON has no inf)
INT4 = 7


def program_runtime(runtime_cfg: Dict[str, Any], params: Dict, device: torch.device):
    """``BackboneRuntime`` from the configuration's ``runtime`` keys on ``device``."""
    from team_tpu_torch.config import Config
    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime

    raw = dict(runtime_cfg, device=[device.index or 0] if device.type == "cuda" else ["cpu"])
    return BackboneRuntime(Config.from_dict(raw), params=params)


def gate_int8(runtime, pool: List[torch.Tensor], traffic: Dict) -> Tuple[bool, Optional[float]]:
    """Calibrate an int8 runtime on one pool batch and gate it on another."""
    runtime.encode_image(pool[traffic["calibration_batch"]])
    runtime.encode_image(pool[traffic["gate_batch"]])
    return runtime.int8_committed, runtime.gate_cosine


def row_gaps(program: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each row's ‖program − reference‖ / ‖reference‖."""
    return (program - ref).norm(dim=-1) / ref.norm(dim=-1)


def row_cos_gaps(program: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each row's 1 − cosine(program, reference): the angle between the
    features, which the learners compare by (their int8 gate too)."""
    return 1.0 - torch.nn.functional.cosine_similarity(program, ref, dim=-1, eps=1e-300)


# the numbers a configuration's check may compare, by name
NUMBERS = {"feat_rel_err_max": row_gaps, "feat_cos_gap_max": row_cos_gaps}


def worst_gap(number: str, program: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest row gap by ``number``, in float64 (``MISSING`` where the
    program's rows are of another shape or not finite)."""
    if program.shape != ref.shape:
        return MISSING
    gaps = NUMBERS[number](program.double().cpu(), ref.double().cpu())
    return float(torch.nan_to_num(gaps, nan=MISSING, posinf=MISSING).max())


def _encode_int8_as_bf16(runtime, qv, images):
    """A fault: the int8 tower's every call served by the bf16 tower."""
    from team_tpu_torch.backbone.clip import encode_image_patches_u8

    return encode_image_patches_u8(runtime.params, images, runtime.clip_cfg,
                                   compute_dtype=runtime.compute_dtype,
                                   attn_impl=runtime.attn_impl)


def plant(fault: str, monkeypatch) -> None:
    """Plant a named fault in the program (for the control tool and tests):
    ``bf16_tower``, an int8 tower that reports itself committed while every
    call runs the bf16 tower."""
    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime

    if fault != "bf16_tower":
        raise ValueError(f"unknown fault {fault!r}")
    monkeypatch.setattr(BackboneRuntime, "_encode_int8", _encode_int8_as_bf16)


def _synced(device: torch.device, stamps: List[float]) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stamps.append(time.perf_counter())


class System:
    """The runtime and its inputs for one run of an ``encode`` cell."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device: torch.device,
                 families: List[Dict]):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.families = families
        self.shape = work.VisionShape.from_config(cfg)
        self.items_per_step = traffic["batch"]
        self.int8 = cfg["runtime"].get("encoder_quant") == "int8_static"
        stamps = [time.perf_counter()]
        params = weights.clip_params(cfg, seed, device)
        self.pool = gen.image_pool(traffic, self.shape, seed, device)
        _synced(device, stamps)
        self.runtime = program_runtime(cfg["runtime"], params, device)
        del params
        self._check_shape()
        _synced(device, stamps)
        self.committed: Optional[bool] = None   # the int8 tower's gate (None: a bf16 cell)
        self.gate_cosine: Optional[float] = None
        if self.int8:
            self.committed, self.gate_cosine = gate_int8(self.runtime, self.pool, traffic)
        _synced(device, stamps)
        # seconds of set-up by part (the first includes CUDA's start)
        self.phases = dict(zip(("weights_and_pool", "runtime", "gate"),
                               (b - a for a, b in zip(stamps, stamps[1:]))))
        self.off_precision: Optional[float] = None
        self.refs: Dict[int, torch.Tensor] = {}

    def _check_shape(self) -> None:
        """The tower the runtime built has the configuration file's sizes."""
        v, s = self.runtime.clip_cfg.vision, self.shape
        built = (v.image_size, v.patch_size, v.width, v.layers, v.heads,
                 self.runtime.clip_cfg.embed_dim)
        stated = (s.image_size, s.patch_size, s.width, s.layers, s.heads, s.embed_dim)
        if built != stated:
            raise ValueError(f"the runtime built a tower of {built}, the configuration states {stated}")

    def step(self, i: int) -> torch.Tensor:
        return self.runtime.encode_image(self.pool[i % len(self.pool)])

    def describe(self) -> Dict[str, Any]:
        return {"committed": self.committed, "gate_cosine": self.gate_cosine} if self.int8 else {}

    def after_window(self, kernels: Optional[Dict[str, float]]) -> None:
        """Read which kernels did the tower's math: from the traced window's
        ``kernels``, else from one profiled step (on a card only)."""
        if self.device.type != "cuda":
            return
        if kernels is None:
            def body():
                self.step(0)
                torch.cuda.synchronize(self.device)
            kernels = tracing.profile_window(body).kernels
        share = off_precision_share(kernels, self.families, self.cfg["precision"])
        self.off_precision = MISSING if share is None else share

    def free(self) -> None:
        self.runtime = None

    def reference_features(self, indices: List[int], qmax: Optional[int] = None):
        """The reference's features of the pool batches the window's steps
        ``indices`` sent, from the benchmark's weights drawn again from the seed."""
        params = weights.clip_params(self.cfg, self.seed, self.device)
        calibration = self.pool[self.traffic["calibration_batch"]] if self.int8 else None
        feats = reference.features(self.cfg, params, [self.pool[i % len(self.pool)] for i in indices],
                                   calibration, qmax=qmax)
        del params
        return feats

    def check(self, outputs: Dict[int, torch.Tensor]) -> Tuple[Dict[str, Dict], int, bool]:
        """The sampled outputs against the reference: each compared number
        with its limit, the compared steps that failed, and whether all passed."""
        spec = self.cfg["check"]
        indices = sorted(outputs)
        worst, failed = MISSING, len(indices) or 1
        if indices:
            self.refs = dict(zip(indices, self.reference_features(indices)))
            gaps = [worst_gap(spec["number"], outputs[i], self.refs[i]) for i in indices]
            worst = max(gaps)
            failed = sum(g > spec["limit"] for g in gaps)
        checks = {spec["number"]: {"value": worst, "limit": spec["limit"]}}
        ok = worst <= spec["limit"]
        if self.off_precision is not None:
            limit = spec["off_precision_share"]
            checks["off_precision_share"] = {"value": self.off_precision, "limit": limit}
            ok = ok and self.off_precision <= limit
        if self.int8:
            checks["int8_committed"] = {"value": float(bool(self.committed)), "limit": 1.0}
            ok = ok and bool(self.committed)
        return checks, failed, ok

    def all_failed(self) -> bool:
        """Every step was served by the wrong tower: an int8 tower that did
        not commit serves bf16, and one off its precision runs other kernels."""
        off = self.off_precision is not None and self.off_precision > self.cfg["check"]["off_precision_share"]
        return (self.int8 and not self.committed) or off

    def control(self, indices: List[int]) -> Dict[str, Any]:
        """The control's largest row gap over the checked steps, against the
        references :meth:`check` computed: ``program_int8``, the program's own
        int8 static tower on the same weights, calibrated and gated as in a run;
        ``reference_int4``, the reference's int8 scheme in int4 in the program's place."""
        kind, number = self.cfg["check"]["control"], self.cfg["check"]["number"]
        out: Dict[str, Any] = {}
        if kind == "program_int8":
            params = weights.clip_params(self.cfg, self.seed, self.device)
            runtime_cfg = dict(self.cfg["runtime"], encoder_quant="int8_static",
                               int8_gemm_impl="static3d_qi")
            runtime = program_runtime(runtime_cfg, params, self.device)
            del params
            out["control_committed"], out["control_gate_cosine"] = gate_int8(
                runtime, self.pool, self.traffic)
            feats = [runtime.encode_image(self.pool[i % len(self.pool)]) for i in indices]
            del runtime
        elif kind == "reference_int4":
            feats = self.reference_features(indices, qmax=INT4)
        else:
            raise ValueError(f"unknown control {kind!r}")
        out["control"] = max(worst_gap(number, f, self.refs[i]) for f, i in zip(feats, indices))
        return out
