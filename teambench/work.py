"""Operations and bytes of the image tower, computed from its shapes.

The yardstick of the rooflines and of ``encode_mfu_pct``: a layer's roofline
reads the work its layer must do, whatever kernels do it. A bound counts each
input byte read once and each output byte written once, at the precision the
next stage takes, and the larger of operations over the peak and bytes over
the memory bandwidth (``peaks.json``). The pooled feature needs only the CLS
row of the last block after its attention's keys and values, so the bounds
count the last block's query, out-projection and MLP on that row alone; a
route that computes every row there does work the bound does not count.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional

PEAKS = Path(__file__).resolve().parent / "peaks.json"
BYTES = {"bf16": 2, "int8": 1, "u8": 1}


@dataclasses.dataclass(frozen=True)
class VisionShape:
    """The image tower's sizes, as a configuration file states them."""
    image_size: int
    patch_size: int
    width: int
    layers: int
    heads: int
    embed_dim: int
    mlp_ratio: float = 4.0

    @classmethod
    def from_config(cls, cfg: Dict) -> "VisionShape":
        """From open_clip's keys: ``vision_cfg`` and ``embed_dim``; the heads
        are ``width // head_width`` (open_clip's default head width is 64)."""
        v = cfg["vision_cfg"]
        return cls(v["image_size"], v["patch_size"], v["width"], v["layers"],
                   v["width"] // v.get("head_width", 64), cfg["embed_dim"],
                   float(v.get("mlp_ratio", 4.0)))

    @property
    def tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq(self) -> int:
        return self.tokens + 1

    @property
    def head_dim(self) -> int:
        return self.width // self.heads

    @property
    def patch_dim(self) -> int:
        return 3 * self.patch_size ** 2

    @property
    def mlp_width(self) -> int:
        return int(self.width * self.mlp_ratio)


@dataclasses.dataclass(frozen=True)
class Op:
    """Work of one kernel-sized step: operations by the peak they run at, and bytes."""
    ops: Dict[str, float]
    bytes: float


def _gemm(m: int, k: int, n: int, a: str, w: str, c: str, peak: str) -> Op:
    return Op({peak: 2.0 * m * k * n}, m * k * BYTES[a] + k * n * BYTES[w] + m * n * BYTES[c])


def gemm(shape: VisionShape, batch: int, precision: str) -> List[Op]:
    """The tower's GEMMs for one batch: the patch embedding, each block's qkv,
    out, fc and proj, and the final projection. In ``int8`` the patch and
    block GEMMs take int8 operands (the patch input is uint8) and write what
    the next stage takes: q/k/v and the GELU's output in int8, the residual
    branches and the tokens in bf16; the final projection stays bf16."""
    d, f, s = shape.width, shape.mlp_width, shape.seq
    q = "int8" if precision == "int8" else "bf16"
    a_patch = "u8" if precision == "int8" else "bf16"
    rows = batch * s
    ops = [_gemm(batch * shape.tokens, shape.patch_dim, d, a_patch, q, "bf16", q)]
    for layer in range(shape.layers):
        # the last block past its keys and values: the CLS row alone
        r = batch if layer == shape.layers - 1 else rows
        ops += [_gemm(rows, d, 2 * d, q, q, q, q), _gemm(r, d, d, q, q, q, q),
                _gemm(r, d, d, q, q, "bf16", q), _gemm(r, d, f, q, q, q, q),
                _gemm(r, f, d, q, q, "bf16", q)]
    ops.append(_gemm(batch, d, shape.embed_dim, "bf16", "bf16", "bf16", "bf16"))
    return ops


def attention_layer_ops(batch: int, heads: int, rows: int, seq: int, head_dim: int) -> float:
    """QKᵀ and PV of one layer: 4·B·H·rows·S·dh operations."""
    return 4.0 * batch * heads * rows * seq * head_dim


def attention(shape: VisionShape, batch: int, precision: str) -> List[Op]:
    """Each block's attention over q/k/v/o at the config's operand precision
    (``int8``: q·k on the int8 peak, PV on the bf16 one, as p is bf16); the
    last block's CLS query alone."""
    h, s, dh, d = shape.heads, shape.seq, shape.head_dim, shape.width
    e = BYTES["int8" if precision == "int8" else "bf16"]
    out = []
    for layer in range(shape.layers):
        rows = 1 if layer == shape.layers - 1 else s
        flops = attention_layer_ops(batch, h, rows, s, dh)
        ops = {"int8": flops / 2, "bf16": flops / 2} if precision == "int8" else {"bf16": flops}
        out.append(Op(ops, batch * d * e * (2 * s + 2 * rows)))
    return out


WORK = {"gemm": gemm, "attention": attention}


def model_flops_per_image(shape: VisionShape) -> float:
    """Model FLOPs of one image, every token in every block (the usual count):
    2 × block parameters × S, the attention, the patch embedding and the final
    projection (about 35.1 GFLOP at ViT-B/16)."""
    d, f, s = shape.width, shape.mlp_width, shape.seq
    block_params = d * 3 * d + d * d + d * f + f * d
    return (2.0 * block_params * s * shape.layers
            + shape.layers * attention_layer_ops(1, shape.heads, s, s, shape.head_dim)
            + 2.0 * shape.tokens * shape.patch_dim * d + 2.0 * d * shape.embed_dim)


def bound_seconds(ops: List[Op], peaks: Dict[str, float]) -> float:
    """The least time the card could take: per step, the larger of its
    operations over their peaks and its bytes over the memory bandwidth."""
    return sum(max(sum(n / peaks[p] for p, n in op.ops.items()),
                   op.bytes / peaks["hbm_bytes_per_s"]) for op in ops)


def peaks_for(kind: str) -> Optional[Dict[str, float]]:
    """The published dense peaks of the card ``kind`` names, or None."""
    table = json.loads(PEAKS.read_text())["cards"]
    return table.get(kind)
