"""The benchmark's operation and byte counts at ViT-B/16 (`PERF.md` §6's
arithmetic), and the bound they make."""

import json

import pytest

from teambench import work
from teambench.manifest import ROOT

SHAPE = work.VisionShape.from_config(
    json.loads((ROOT / "teambench/configs/clip-vitb16-bf16.json").read_text()))
PEAKS = work.peaks_for("NVIDIA H100 80GB HBM3")


def test_vitb16_shape():
    assert (SHAPE.seq, SHAPE.heads, SHAPE.head_dim, SHAPE.mlp_width, SHAPE.patch_dim) == \
        (197, 12, 64, 3072, 768)


def test_attention_layer_at_b128():
    """15.26 GFLOP a layer; q/k/v/o 154.8 MB in bf16, 77.5 MB in int8."""
    assert work.attention_layer_ops(128, 12, 197, 197, 64) == pytest.approx(15.2603e9, rel=1e-4)
    bf16, int8 = work.attention(SHAPE, 128, "bf16"), work.attention(SHAPE, 128, "int8")
    assert bf16[0].bytes == pytest.approx(154.8e6, rel=1e-3)
    assert int8[0].bytes == pytest.approx(77.5e6, rel=1e-3)
    # the last block's CLS query: one row of q and o, every key and value
    assert sum(bf16[-1].ops.values()) == work.attention_layer_ops(128, 12, 1, 197, 64)
    assert sum(int8[0].ops.values()) == sum(bf16[0].ops.values())


def test_model_flops_per_image():
    """About 35.1 GFLOP: 2 × 84.9 M block parameters × 197 tokens, attention
    1.43 G, patch embedding 0.23 G."""
    block_params = 12 * (768 * 2304 + 768 * 768 + 2 * 768 * 3072)
    assert block_params == pytest.approx(84.93e6, rel=1e-3)
    assert work.model_flops_per_image(SHAPE) == pytest.approx(35.13e9, rel=1e-3)


def test_gemm_work():
    """Every row in the first eleven blocks, the CLS row past the keys and
    values in the last; the same operations in either precision."""
    bf16, int8 = work.gemm(SHAPE, 128, "bf16"), work.gemm(SHAPE, 128, "int8")
    ops = sum(sum(o.ops.values()) for o in bf16)
    rows, d = 128 * 197, 768
    full = 2 * rows * d * (3 * d + d + 2 * 4 * d)
    last = 2 * rows * d * 2 * d + 2 * 128 * d * (d + d + 2 * 4 * d)
    patch, proj = 2 * 128 * 196 * 768 * d, 2 * 128 * d * 512
    assert ops == pytest.approx(11 * full + last + patch + proj)
    assert sum(sum(o.ops.values()) for o in int8) == pytest.approx(ops)
    assert {p for o in int8[:-1] for p in o.ops} == {"int8"} and set(int8[-1].ops) == {"bf16"}


def test_bound_takes_the_larger_of_operations_and_bytes():
    compute = work.Op({"bf16": 989e12}, 0.0)
    memory = work.Op({"bf16": 0.0}, 3.35e12)
    both = work.Op({"int8": 1979e12, "bf16": 989e12}, 3.35e12)
    assert work.bound_seconds([compute], PEAKS) == pytest.approx(1.0)
    assert work.bound_seconds([memory], PEAKS) == pytest.approx(1.0)
    assert work.bound_seconds([both], PEAKS) == pytest.approx(2.0)
    assert work.bound_seconds([compute, memory], PEAKS) == pytest.approx(2.0)
    assert work.peaks_for("a card with no entry") is None
