"""The port's spans and counters (team_tpu_torch/utils/phase_timer.py) on the
CPU: off they record nothing and open no profiler range; on they nest, know
their parents and self time, keep bounded memory and land in a
``torch.profiler`` trace as ``user_annotation`` ranges; the switch is
``enable()`` or ``TEAM_PHASE_TIMES``; and ``BackboneRuntime.encode_image``
on the tiny tower, bf16 and int8 ``static3d_qi``, opens the stage spans of
the encode path in their order and nesting."""

import importlib.util
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from team_tpu_torch.config import Config
from team_tpu_torch.learners.backbone_runtime import BackboneRuntime
from team_tpu_torch.utils import phase_timer as pt

ENCODE_SPANS = (pt.ENCODE_IMAGE, pt.CALIBRATE, pt.GATE, pt.EMBED, pt.ATTN_BLOCK, pt.MLP_BLOCK,
                pt.HEAD)


@pytest.fixture
def timer():
    was = pt.enabled()
    pt.reset()
    yield pt
    pt.enable(was)
    pt.reset()


def _annotations(prof, tmp_path, names):
    """The ``user_annotation`` events of ``names`` in the profile, in time order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e for e in events if e.get("cat") == "user_annotation" and e["name"] in names),
                  key=lambda e: (e["ts"], -e["dur"]))


def _fake_clock(monkeypatch, times):
    ticks = iter(times)
    monkeypatch.setattr(pt.time, "perf_counter", lambda: next(ticks))


def test_off_records_nothing_and_opens_no_range(timer, tmp_path):
    timer.enable(False)
    assert timer.phase("a") is timer.phase("b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.phase("off.span"):
            torch.ones(4).add_(1)
        timer.count("off.counter", 3)
    assert _annotations(prof, tmp_path, {"off.span"}) == []
    assert timer.report() == {"spans": {}, "counters": {}}


def test_nesting_parents_and_self_time(timer, monkeypatch):
    timer.enable(True)
    _fake_clock(monkeypatch, [0.0, 1.0, 3.0, 4.0, 5.0, 10.0, 20.0, 22.0])
    with timer.phase("outer"):
        with timer.phase("inner"):
            pass
        with timer.phase("inner"):
            pass
    with pytest.raises(ValueError):
        with timer.phase("inner"):
            raise ValueError("a span left by an exception still closes")
    spans = timer.report()["spans"]
    assert spans["outer"] == {"count": 1, "sum": 10.0, "first": 10.0, "rest_mean": None,
                              "self": 7.0, "parents": {None: 1}, "calls": [10.0]}
    assert spans["inner"] == {"count": 3, "sum": 5.0, "first": 2.0, "rest_mean": 1.5,
                              "self": 5.0, "parents": {"outer": 2, None: 1},
                              "calls": [2.0, 1.0, 2.0]}
    assert pt._stack() == []


def test_counter_counts_only_while_on(timer):
    timer.enable(False)
    timer.count(pt.KERNELS_BUILT, 5)
    timer.enable(True)
    timer.count(pt.KERNELS_BUILT)
    timer.count(pt.KERNELS_BUILT, 2)
    timer.count("other")
    assert timer.report()["counters"] == {pt.KERNELS_BUILT: 3, "other": 1}
    assert "(counter)" in timer.format_report()


@pytest.mark.parametrize("env,want", [(None, False), ("0", False), ("1", True)])
def test_enable_and_the_environment_switch(timer, monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("TEAM_PHASE_TIMES", raising=False)
    else:
        monkeypatch.setenv("TEAM_PHASE_TIMES", env)
    spec = importlib.util.spec_from_file_location("phase_timer_fresh", pt.__file__)
    fresh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fresh)
    assert fresh.enabled() is want
    with fresh.phase("x"):
        pass
    assert bool(fresh.report()["spans"]) is want
    fresh.enable(not want)
    assert fresh.enabled() is (not want)
    assert pt.report()["spans"] == {}  # the module the port imports is another


def test_memory_stays_bounded_over_ten_thousand_spans(timer):
    timer.enable(True)
    with timer.phase("parent"):
        for _ in range(10_000):
            with timer.phase("child"):
                timer.count("n")
    child = timer.report()["spans"]["child"]
    assert child["count"] == 10_000 and child["parents"] == {"parent": 10_000}
    assert len(child["calls"]) == pt.CALLS_KEPT == len(pt._SPANS["child"].calls)
    assert len(pt._SPANS) == 2 and timer.report()["counters"] == {"n": 10_000}
    assert pt._stack() == []


def test_spans_are_user_annotations_in_a_profiler_trace(timer, tmp_path):
    timer.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.phase("trace.outer"):
            with timer.phase("trace.inner"):
                torch.ones(8).mul_(2)
    outer, inner = _annotations(prof, tmp_path, {"trace.outer", "trace.inner"})
    assert (outer["name"], inner["name"]) == ("trace.outer", "trace.inner")
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("quant", ["bf16", "int8_static"])
def test_encode_image_opens_the_stage_spans(timer, tmp_path, quant):
    """bf16: one call; int8: the calibration call, the gate call and a call
    on the committed (or fallen-back) tower, whose stages all run in the
    same spans. The tiny tower has two layers."""
    cfg = Config(convnet_type="clip", device=["cpu"], compute_dtype="bfloat16",
                 encoder_quant=quant, extras={"tiny_backbone": True})
    runtime = BackboneRuntime(cfg, seed=0)
    g, dim = runtime.clip_cfg.vision.grid, 3 * runtime.clip_cfg.vision.patch_size ** 2
    rng = np.random.default_rng(3)
    calls = 3 if quant == "int8_static" else 1
    batches = [torch.from_numpy(rng.integers(0, 256, (4, g * g, dim), dtype=np.uint8))
               for _ in range(calls)]
    timer.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for images in batches:
            assert runtime.encode_image(images).shape == (4, runtime.out_dim)
    tower = [pt.EMBED] + [pt.ATTN_BLOCK, pt.MLP_BLOCK] * 2 + [pt.HEAD]
    if quant == "bf16":
        order = [pt.ENCODE_IMAGE] + tower
        parents = {pt.ENCODE_IMAGE: {None: 1}, pt.EMBED: {pt.ENCODE_IMAGE: 1},
                   pt.ATTN_BLOCK: {pt.ENCODE_IMAGE: 2}, pt.MLP_BLOCK: {pt.ENCODE_IMAGE: 2},
                   pt.HEAD: {pt.ENCODE_IMAGE: 1}}
    else:
        order = ([pt.ENCODE_IMAGE, pt.CALIBRATE, pt.ENCODE_IMAGE, pt.GATE] + tower
                 + [pt.ENCODE_IMAGE] + tower)
        twice = {pt.GATE: 1, pt.ENCODE_IMAGE: 1}
        parents = {pt.ENCODE_IMAGE: {None: 3}, pt.CALIBRATE: {pt.ENCODE_IMAGE: 1},
                   pt.GATE: {pt.ENCODE_IMAGE: 1}, pt.EMBED: twice,
                   pt.ATTN_BLOCK: {pt.GATE: 2, pt.ENCODE_IMAGE: 2},
                   pt.MLP_BLOCK: {pt.GATE: 2, pt.ENCODE_IMAGE: 2}, pt.HEAD: twice}
    assert [e["name"] for e in _annotations(prof, tmp_path, set(ENCODE_SPANS))] == order
    spans = timer.report()["spans"]
    assert {name: s["parents"] for name, s in spans.items()} == parents


def _siglip_27_blocks():
    """SigLIP So400m/14's tower of 27 blocks at a tiny width (2 heads of 72,
    patch 14 at 46 px: 9 tokens)."""
    import dataclasses

    from team_tpu_torch.backbone.clip import CLIPConfig

    full = CLIPConfig.siglip_so400m14_384()
    v = dataclasses.replace(full.vision, image_size=46, width=144, heads=2, embed_dim=144,
                            mlp_width=538)
    return dataclasses.replace(full, vision=v, embed_dim=144)


@pytest.mark.parametrize("convnet", ["siglip_so400m14_384", "clip"])
def test_flash_calls_count_the_blocks_and_the_head_of_siglip(timer, tmp_path, monkeypatch,
                                                             convnet):
    """``attention.flash_calls``: 27 blocks and the attention-pool head a
    SigLIP batch, none on ViT-B/16 (its blocks take the packed kernel); the
    head's operations, ``ln_post`` and the pool, run inside ``tower.head``."""
    from team_tpu_torch.learners import backbone_runtime as br

    if convnet == br.SIGLIP:
        monkeypatch.setattr(br, "clip_config_for", lambda c: _siglip_27_blocks())
    cfg = Config(convnet_type=convnet, device=["cpu"], compute_dtype="bfloat16",
                 extras={} if convnet == br.SIGLIP else {"tiny_backbone": True})
    runtime = BackboneRuntime(cfg, seed=0)
    v = runtime.clip_cfg.vision
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.integers(0, 256, (2, v.grid ** 2, 3 * v.patch_size ** 2),
                                           dtype=np.uint8))
    timer.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            runtime.encode_image(images)
    calls = timer.report()["counters"].get(pt.FLASH_CALLS, 0)
    assert calls == (2 * 28 if convnet == br.SIGLIP else 0)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"] in ENCODE_SPANS), key=lambda e: e["ts"])
    encode, last_mlp = spans[-1 - (2 + 2 * v.layers)], None
    for e in spans:
        if e["name"] == pt.MLP_BLOCK and e["ts"] < encode["ts"] + encode["dur"]:
            last_mlp = e
    head = [e for e in spans if e["name"] == pt.HEAD][-1]
    assert [e["name"] for e in spans].count(pt.ATTN_BLOCK) == 2 * v.layers
    # every operation after the last block's MLP half, in the last encode, lies in the head
    later = [e for e in events if e.get("cat") == "cpu_op" and e.get("ph") == "X"
             and last_mlp["ts"] + last_mlp["dur"] <= e["ts"] < encode["ts"] + encode["dur"]]
    assert later and all(head["ts"] <= e["ts"] and e["ts"] + e["dur"] <= head["ts"] + head["dur"]
                         for e in later)
    if convnet == br.SIGLIP:
        assert any(e["name"] in ("aten::softmax", "aten::exp", "aten::_softmax") for e in later)
