"""The harness on the CPU at the port's tiny backbone: a run end to end, the
reference against ``team_tpu_torch``, and the faults the check must catch."""

import json
import time

import pytest
import torch

from teambench import cell, control, traffic, weights, work
from teambench.manifest import Manifest
from teambench.reference import clip as reference
from teambench.tests.tiny import tiny_root

CPU = torch.device("cpu")
CELLS = ("vitb16-bf16.encode-b128", "vitb16-int8.encode-b128")
SEEDS = (5, 2 ** 31 + 11)  # a seed above 32 signed bits too


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    return Manifest(tiny_root(tmp_path_factory.mktemp("tiny")))


def run(manifest, workload, seed, seconds=0.5):
    # long enough for two or more tiny batches on a busy CPU: a percentile needs two
    return cell.run(workload, seed, seconds, False, manifest=manifest, device=CPU,
                    t_start=time.perf_counter())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", CELLS)
def test_run_is_correct_and_reports_its_metrics(manifest, workload, seed):
    result = run(manifest, workload, seed)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"encode_img_per_s", "encode_p95_ms", "setup_s"}
    assert list(result)[-1] == "checks"
    json.dumps(result, allow_nan=False)


@pytest.mark.parametrize("workload", CELLS)
def test_same_seed_same_inputs_and_weights(manifest, workload):
    cfg = manifest.config(manifest.workload(workload)["config"])
    tr = manifest.traffic(manifest.workload(workload)["traffic"])
    shape = work.VisionShape.from_config(cfg)
    a = traffic.image_pool(tr, shape, 7, CPU)
    b = traffic.image_pool(tr, shape, 7, CPU)
    c = traffic.image_pool(tr, shape, 8, CPU)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert len(a) == tr["pool_batches"] and a[0].shape == (tr["batch"], shape.tokens,
                                                          shape.patch_dim)
    pa, pb = weights.clip_params(cfg, 7, CPU), weights.clip_params(cfg, 7, CPU)
    assert torch.equal(pa["vision"]["blocks"][1]["mlp"]["fc_w"], pb["vision"]["blocks"][1]["mlp"]["fc_w"])
    assert traffic.check_sample(tr, 7, 3) == traffic.check_sample(tr, 7, 3)


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_port(manifest, workload):
    """The port's features (``BackboneRuntime``, its plain versions on the
    CPU) within the cell's limit of the reference's, on every seed tried,
    and the reference's int8 scheme farther from its bf16 tower than that."""
    spec = manifest.config(manifest.workload(workload)["config"])["check"]
    for seed in (1, 2, 3):
        row = control.readings(manifest, workload, seed, CPU, with_control=False)
        assert row["correct"] and row["checks"][spec["number"]] <= spec["limit"], row
        assert row.get("committed", True)


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limit(manifest, workload):
    """The lower precision in the program's place (the program's int8 tower
    for the bf16 cell, the int4 reference for the int8 cell) is not correct."""
    limit = manifest.config(manifest.workload(workload)["config"])["check"]["limit"]
    for seed in (1, 2, 3):
        row = control.readings(manifest, workload, seed, CPU, with_control=True)
        assert row["control"] > limit, row


def _broken(manifest, workload, monkeypatch, fault):
    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime

    encode = BackboneRuntime.encode_image
    last = {}

    def broken(self, images):
        if not getattr(self, "_qvision", None) and self.encoder_quant == "int8_static":
            return encode(self, images)  # calibration and gate run as they are
        if fault == "half":  # half of the batch left out, the mean taken over the rest
            half = encode(self, images[: images.shape[0] // 2])
            return torch.cat([half, half.mean(dim=0, keepdim=True).expand_as(half)])
        out = encode(self, images)
        if fault == "altered":  # one answer altered where it is produced
            out = out.clone()
            out[0] = out[0].roll(1)
        if fault == "stale":  # the previous call's answers returned unchanged
            out, last["out"] = last.get("out", out), out
        return out

    monkeypatch.setattr(BackboneRuntime, "encode_image", broken)
    return run(manifest, workload, SEEDS[0])


@pytest.mark.parametrize("fault", ("half", "altered", "stale"))
@pytest.mark.parametrize("workload", CELLS)
def test_faults_make_the_run_incorrect(manifest, workload, fault, monkeypatch):
    result = _broken(manifest, workload, monkeypatch, fault)
    assert not result["correct"] and result["failed"] >= 1


def test_int8_tower_that_does_not_commit_fails(manifest, monkeypatch):
    from team_tpu_torch.learners import backbone_runtime

    monkeypatch.setattr(backbone_runtime, "GATE_MIN_COSINE", 1.5)
    result = run(manifest, CELLS[1], SEEDS[0])
    assert not result["correct"] and result["failed"] == result["attempted"]
    assert result["checks"]["int8_committed"]["value"] == 0.0


def test_reference_int4_is_the_int8_scheme_at_qmax_7(manifest):
    cfg = manifest.config("clip-vitb16-int8")
    shape = work.VisionShape.from_config(cfg)
    tr = manifest.traffic("encode-b128")
    params = weights.clip_params(cfg, 3, CPU)
    pool = traffic.image_pool(tr, shape, 3, CPU)
    int8 = reference.features(cfg, params, pool[1:2], pool[0])[0]
    int4 = reference.features(cfg, params, pool[1:2], pool[0], qmax=7)[0]
    bf16 = reference.features(dict(cfg, reference={"kind": "bf16"}), params, pool[1:2])[0]
    encode = manifest.driver("encode")
    gap8 = encode.worst_gap("feat_rel_err_max", int8, bf16)
    gap4 = encode.worst_gap("feat_rel_err_max", int4, bf16)
    assert 0 < gap8 < gap4
