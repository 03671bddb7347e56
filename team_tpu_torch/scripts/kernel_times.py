"""Each hand-written kernel of the port timed alone on the card, for PERF.md
§6's table of TPU kernels:

    python -m team_tpu_torch.scripts.kernel_times      # card 0

One entry of :func:`table` per row (the main paths' shapes: B=128, S=197, H=12,
dh=64, M=25,216; the text tower B=32, S=77, H=8, causal; bf16 unless
named): the kernel's call, its plain version, the library call that
computes the same where there is one (else a composition of PyTorch calls,
or none), and the bytes and operations the call needs. Each is timed by
``_timing.spin_ms`` (CUDA events over 20 calls queued behind a device spin,
after 3 warm-up calls) in the order plain, kernel, kernel, plain, then the
library call. The bound is the larger of the bytes over the card's memory
rate and the operations over the peak of their type, both from
``teambench/peaks.json``. The card's name and power limit come first; then
one line and one JSON row per entry: card ms (the two kernel runs' mean),
bound ms and what bounds it, plain ms, library ms, and the largest
|kernel − plain| on the entry's inputs, read before the timing (the plain
version first: some kernels write over an input); a reading, the limits are
the card tests' (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import json
import subprocess
from dataclasses import dataclass, field
from functools import partial
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional

import torch
import torch.nn.functional as F

from team_tpu_torch.scripts._timing import spin_ms

PEAKS = Path(__file__).resolve().parents[2] / "teambench" / "peaks.json"
B, S, H, DH = 128, 197, 12, 64  # the vision tower at the learners' eval batch
D, M = H * DH, B * S
TEXT = (32, 77, 8)  # the text tower at 32 prompts: B, S, H (causal)
BF16 = torch.bfloat16


@dataclass
class Entry:
    """One timed call: ``row`` of PERF.md §6's table and its ``label``; the
    kernel's call, its plain version, and the library call (``library``
    names it) or None; the bytes the call reads and writes once each and its
    operations by type (``bf16``, ``int8``, ``f32``)."""
    row: str
    label: str
    kernel: Callable
    plain: Callable
    library: Optional[Callable]
    library_name: str
    nbytes: float
    ops: Dict[str, float] = field(default_factory=dict)


def _randn(*shape, seed=0, dtype=torch.float32, std=1.0, mean=0.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda") * std + mean).to(dtype)


def _uniform(shape, lo, hi, g):
    return torch.rand(shape, generator=g, device="cuda") * (hi - lo) + lo


def attention_ops(b, h, s, dh, causal=False, rows=None) -> int:
    """Multiply-adds of QKᵀ and PV, two operations each: 4·B·H·(query, key
    pairs)·dh; a causal mask needs the lower triangle only."""
    pairs = s * (s + 1) // 2 if causal else (rows or s) * s
    return 4 * b * h * pairs * dh


def sdpa(q, k, v, causal=False):
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal)


def _packed(ms, fa) -> Iterator[Entry]:
    """#1, #2 (one rank's launch), #3 and #14 against SDPA."""
    for tower, (b, s, h), causal in (("vision", (B, S, H), False), ("text", TEXT, True)):
        qkv = _randn(b, s, 3 * h * DH, seed=1, dtype=BF16)
        q, k, v = (t.reshape(b, s, h, DH).transpose(1, 2) for t in qkv.split(h * DH, dim=-1))
        yield Entry(f"#1 {tower}", f"fused_mha_packed B={b} S={s} H={h}",
                    partial(ms.fused_mha_packed, qkv, h, causal=causal),
                    partial(ms.mha_packed_reference, qkv, h, causal),
                    partial(sdpa, q, k, v, causal), "scaled_dot_product_attention",
                    qkv.numel() * 2 + b * s * h * DH * 2,
                    {"bf16": attention_ops(b, h, s, DH, causal)})
        for nm in (2, 4) if tower == "vision" else (2,):
            hm = h // nm
            qr, kr, vr = (t[:, :hm] for t in (q, k, v))
            yield Entry(f"#2 {tower} nm={nm}", f"fused_mha_packed_tp, rank 0 of {nm}",
                        partial(_on_rank, ms, nm, partial(ms.fused_mha_packed_tp, qkv, h,
                                                          causal=causal)),
                        partial(ms.mha_packed_tp_plain, qkv, h, 0, nm, causal=causal),
                        partial(sdpa, qr, kr, vr, causal), "SDPA on the rank's head views",
                        qkv.numel() * 2 // nm + b * s * hm * DH * 2,
                        {"bf16": attention_ops(b, hm, s, DH, causal)})
    q, k, v = (_randn(B, H, S, DH, seed=5 + i, dtype=BF16) for i in range(3))
    yield Entry("#3", "fused_mha_short", partial(ms.fused_mha_short, q, k, v),
                partial(ms.mha_short_reference, q, k, v), partial(sdpa, q, k, v),
                "scaled_dot_product_attention", 4 * q.numel() * 2,
                {"bf16": attention_ops(B, H, S, DH)})
    for tag, exp_dtype in (("f32exp", torch.float32), ("bf16exp", BF16)):
        yield Entry(f"#4 {tag}", f"fused_mha_short_v2 {tag}",
                    partial(ms.fused_mha_short_v2, q, k, v, exp_dtype=exp_dtype),
                    partial(ms.mha_short_v2_reference, q, k, v, None, exp_dtype),
                    partial(sdpa, q, k, v), "scaled_dot_product_attention", 4 * q.numel() * 2,
                    {"bf16": attention_ops(B, H, S, DH)})
    for name, (b, h, s, dh, causal, kv_len) in (("vision", (B, H, S, DH, False, None)),
                                                ("text", (32, 8, 77, DH, True, 77)),
                                                ("siglip", (B, 16, 729, 72, False, None))):
        q, k, v = (_randn(b, h, s, dh, seed=1 + i, dtype=BF16) for i in range(3))
        yield Entry(f"#14 {name}", f"flash_attention B={b} H={h} S={s} dh={dh}",
                    partial(fa.flash_attention, q, k, v, kv_len, causal=causal),
                    partial(fa.flash_attention_reference, q, k, v, kv_len, causal=causal),
                    partial(sdpa, q, k, v, causal), "scaled_dot_product_attention",
                    4 * q.numel() * 2, {"bf16": attention_ops(b, h, s, dh, causal)})


class _Layout:
    def __init__(self, rank: int, nm: int):
        self.model_rank, self.n_model = rank, nm


def _on_rank(ms, nm: int, call: Callable):
    """``call()`` as model rank 0 of ``nm`` (the ranks do equal work)."""
    ms.set_tp_mesh(_Layout(0, nm))
    try:
        return call()
    finally:
        ms.set_tp_mesh(None)


def _fused(ms) -> Iterator[Entry]:
    """#12 and #13 at the vision shape (bf16 and f32) and the text shape,
    against the chain of PyTorch calls that computes the same."""
    for tower, dtype in (("vision", BF16), ("vision", torch.float32), ("text", BF16)):
        b, s, h = (B, S, H) if tower == "vision" else TEXT
        d, size = h * DH, 2 if dtype == BF16 else 4
        kind = "bf16" if dtype == BF16 else "f32"
        x = _randn(b, s, d, seed=4, dtype=dtype)
        ln = (_randn(d, seed=5, std=0.3, mean=1.0), _randn(d, seed=6, std=0.2))
        attn = (_randn(d, 3 * d, seed=7, std=d ** -0.5, dtype=dtype),
                _randn(3 * d, seed=8, std=0.5),
                _randn(d, d, seed=9, std=d ** -0.5, dtype=dtype), _randn(d, seed=10, std=0.5))
        qkv = _randn(b, s, 3 * d, seed=11, dtype=dtype)
        causal = tower == "text"
        act = b * s * d * size
        attn_ops, proj_ops = attention_ops(b, h, s, DH, causal), 2 * b * s * d * d
        yield Entry(f"#12 {tower} {kind}", f"fused_mha_packed_proj B={b} S={s} H={h}",
                    partial(ms.fused_mha_packed_proj, qkv, attn[2], attn[3], x, h, causal=causal),
                    partial(ms.mha_packed_proj_reference, qkv, attn[2], attn[3], x, h, causal),
                    partial(_composition, x, ln, attn, qkv, h, causal, False),
                    "composition: SDPA + addmm + add",
                    3 * act + d * d * size + d * 4 + 2 * act, {kind: attn_ops + proj_ops})
        yield Entry(f"#13 {tower} {kind}", f"fused_attn_block B={b} S={s} H={h}",
                    partial(ms.fused_attn_block, x, *ln, *attn, h, causal=causal),
                    partial(ms.attn_block_reference, x, *ln, *attn, h, causal),
                    partial(_composition, x, ln, attn, qkv, h, causal, True),
                    "composition: layer_norm + addmm + SDPA + addmm + add",
                    2 * act + 4 * d * d * size + 6 * d * 4,
                    {kind: 2 * b * s * d * 3 * d + attn_ops + proj_ops})


def _composition(x, ln, attn, qkv, h, causal, with_ln):
    """What #12 (``with_ln`` False: from the packed qkv) or #13 computes, as
    a chain of PyTorch calls: the port never calls it."""
    b, s, d = x.shape
    g, beta = (t.to(x.dtype) for t in ln)
    w_qkv, b_qkv, w_out, b_out = (t.to(x.dtype) for t in attn)
    if with_ln:
        qkv = torch.addmm(b_qkv, F.layer_norm(x, (d,), g, beta).reshape(b * s, d), w_qkv)
    q, k, v = (t.reshape(b, s, h, d // h).transpose(1, 2)
               for t in qkv.reshape(b, s, 3 * d).split(d, dim=-1))
    o = sdpa(q, k, v, causal)
    return x + torch.addmm(b_out, o.transpose(1, 2).reshape(b * s, d), w_out).reshape(b, s, d)


def _q3i_inputs(b, s, h, seed=2):
    """int8 qkv and scales in the ranges of tests/test_torch_mha_q3i.py."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    d = h * DH
    qkv = torch.randint(-127, 128, (b, s, 3 * d), generator=g, device="cuda", dtype=torch.int8)
    return (qkv, _uniform((1, 3 * d), 0.01, 0.03, g),
            _uniform((1, h), 1e-4, 3e-4, g) * 4 / DH ** 0.5, _uniform((1, d), 20, 60, g),
            _uniform((1, h), 3, 6, g))


# the integer-QKᵀ kernel's modes besides the default: name -> (knobs, arguments)
Q3I_MODES = {"exp2i": ({"TEAM_QI_SOFTMAX": "exp2i"}, {}),
             "reduce": ({"TEAM_QI_ROWSUM": "reduce"}, {}),
             "reduce_defer": ({"TEAM_QI_ROWSUM": "reduce"}, {"defer_norm": True}),
             "pv_int8": ({}, {"pv_int8": True}),
             "pv_int8_defer": ({}, {"pv_int8": True, "defer_norm": True})}


def _with_knobs(env: dict, call: Callable):
    """``call()`` with the environment variables of ``env`` set (the port
    reads its knobs at each call)."""
    import os

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return call()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _int8_attention(ms) -> Iterator[Entry]:
    """#5-#11 and #29: int8 in, int8 out; no one PyTorch call computes them
    (#29's copy against ``qkv[..., :D].contiguous()``)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    qkv8 = torch.randint(-127, 128, (B, S, 3 * D), generator=g, device="cuda", dtype=torch.int8)
    deq, oinv = torch.rand((1, 3 * D), generator=g, device="cuda") * 0.02 + 0.01, \
        torch.rand((1, D), generator=g, device="cuda") * 40 + 20
    io_bytes = qkv8.numel() + M * D + (deq.numel() + oinv.numel()) * 4
    yield Entry("#5", "fused_mha_packed_q",
                partial(ms.fused_mha_packed_q, qkv8.reshape(M, 3 * D), deq, oinv, H, seq=S),
                partial(ms.mha_packed_q_reference, qkv8, deq, oinv, H), None, "none",
                io_bytes, {"bf16": attention_ops(B, H, S, DH)})
    yield Entry("#6", "fused_mha_packed_q3", partial(ms.fused_mha_packed_q3, qkv8, deq, oinv, H),
                partial(ms.mha_packed_q_reference, qkv8, deq, oinv, H, bf16_deq=True), None,
                "none", io_bytes, {"bf16": attention_ops(B, H, S, DH)})
    qkv, deq, qks, oinv, m2 = _q3i_inputs(B, S, H)
    args = (qkv, deq, qks, oinv, H)
    vec_bytes = sum(t.numel() * 4 for t in (deq, qks, oinv, m2))
    half = attention_ops(B, H, S, DH) // 2
    full = (qkv.numel() + M * D + vec_bytes, {"int8": half, "bf16": half})
    cls_half = attention_ops(B, H, S, DH, rows=1) // 2
    cls = (B * D + 2 * M * D + B * D + vec_bytes, {"int8": cls_half, "bf16": cls_half})
    yield Entry("#7", "fused_mha_packed_q3i, static softmax",
                partial(ms.fused_mha_packed_q3i, *args, qk_m2=m2),
                partial(ms.mha_packed_q3i_reference, *args, qk_m2=m2), None, "none", *full)
    for mode, (env, kw) in Q3I_MODES.items():
        yield Entry(f"#7 {mode}", f"fused_mha_packed_q3i [{mode}]",
                    partial(_with_knobs, env,
                            partial(ms.fused_mha_packed_q3i, *args, qk_m2=m2, **kw)),
                    partial(_with_knobs, env, partial(ms.mha_packed_q3i_plain, *args, qk_m2=m2,
                                                      **kw)), None, "none", *full)
    yield Entry("#8", "fused_mha_packed_q3i_cls",
                partial(ms.fused_mha_packed_q3i_cls, *args, qk_m2=m2),
                partial(ms.mha_packed_q3i_reference, *args, qk_m2=m2, rows=1), None, "none", *cls)
    q, kv = qkv[:, :1, :D].contiguous(), qkv[:, :, D:].contiguous()
    yield Entry("#9", "fused_mha_packed_q3i_cls_split",
                partial(ms.fused_mha_packed_q3i_cls_split, q, kv, *args[1:], qk_m2=m2),
                partial(ms.mha_packed_q3i_cls_split_plain, q, kv, *args[1:], qk_m2=m2), None,
                "none", *cls)
    qkv_sb = qkv.transpose(0, 1).contiguous()
    yield Entry("#10", "fused_mha_packed_q3i_sb",
                partial(ms.fused_mha_packed_q3i_sb, qkv_sb, *args[1:]),
                partial(ms.mha_packed_q3i_sb_reference, qkv_sb, *args[1:]), None, "none", *full)
    for nm in (2, 4):
        hm, dm = H // nm, D // nm
        ops = attention_ops(B, hm, S, DH) // 2
        yield Entry(f"#11 nm={nm}", f"fused_mha_packed_q3i_tp, rank 0 of {nm}",
                    partial(_on_rank, ms, nm, partial(ms.fused_mha_packed_q3i_tp, *args, qk_m2=m2)),
                    partial(ms.mha_packed_q3i_tp_plain, *args, 0, nm, qk_m2=m2), None, "none",
                    qkv.numel() // nm + M * dm + 4 * (3 * dm + 2 * hm + dm),
                    {"int8": ops, "bf16": ops})
    yield from _variants(ms)


def _variants(ms) -> Iterator[Entry]:
    from team_tpu_torch.scripts import r4_attn_decomp as r4

    qkv, qks, qkm2, oinv = r4.make_inputs(B, torch.device("cuda"))
    g = torch.Generator(device="cuda").manual_seed(3)
    oinv = torch.rand(oinv.shape, generator=g, device="cuda") * 40 + 20
    vecs = (qks.numel() + qkm2.numel() + oinv.numel()) * 4
    out_bytes, pairs, sliced = B * S * r4.D, B * r4.H * S * S, B * r4.H * S * r4.DH
    needs = {"copy": (2 * out_bytes, {}),
             "full": (qkv.numel() + out_bytes + vecs, {"int8": 2 * pairs * r4.DH,
                                                       "bf16": 2 * pairs * (r4.DH + 1)}),
             "qkonly": (2 * out_bytes + B * r4.DH * r4.D + vecs, {"int8": 2 * sliced * r4.DH})}
    needs["noexp"], needs["nopv"] = needs["full"], needs["qkonly"]
    for variant in ms.Q3I_VARIANTS:
        copy = variant == "copy"
        yield Entry(f"#29 {variant}", f"fused_mha_q3i_variant [{variant}]",
                    partial(ms.fused_mha_q3i_variant, qkv, qks, qkm2, oinv, r4.H, variant),
                    partial(ms.mha_q3i_variant_reference, qkv, qks, qkm2, oinv, r4.H, variant),
                    (lambda: qkv[..., :r4.D].contiguous()) if copy else None,
                    "qkv[..., :D].contiguous()" if copy else "none", *needs[variant])


def _gemm_inputs(im, m, k, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    xq, xs = im.quantize_rows(torch.randn((m, k), generator=g, device="cuda"))
    wq, ws = im.quantize_weight(torch.randn((k, n), generator=g, device="cuda") * k ** -0.5)
    return xq, wq, xs, ws, torch.randn(n, generator=g, device="cuda") * 0.1


def _producer_inputs(m, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((m, d), generator=g, device="cuda")
         * (torch.rand((m, 1), generator=g, device="cuda") * 3.5 + 0.5)).to(BF16)
    return (x, torch.rand(d, generator=g, device="cuda") + 0.5,
            torch.rand(d, generator=g, device="cuda") * 0.4 - 0.2,
            torch.rand((1, d), generator=g, device="cuda") * 50 + 10)


def _int8_gemms(im) -> Iterator[Entry]:
    """#15, #20, #21 and #22 at the vision tower's shapes against
    ``torch._int_mm`` alone (the product only; #22 against the ``xla``
    tier's composition)."""
    from team_tpu_torch.backbone import quant

    for site, (k, n) in (("qkv", (D, 3 * D)), ("out", (D, D))):
        xq, wq, xs, ws, bias = _gemm_inputs(im, M, k, n, seed=4)
        yield Entry(f"#15 {site}", f"int8_linear {site} K={k} N={n}",
                    partial(im.int8_linear, xq, wq, xs, ws, bias),
                    partial(im.int8_linear_reference, xq, wq, xs, ws, bias),
                    partial(torch._int_mm, xq, wq), "torch._int_mm alone",
                    M * k + k * n + M * 4 + 2 * n * 4 + M * n * 2, {"int8": 2 * M * k * n})
    k, n = D, 4 * D
    xq, wq, xs, ws, bias = _gemm_inputs(im, M, k, n, seed=5)
    gq, gs = im.int8_linear_gelu_quant(xq, wq, xs, ws, bias)
    yield Entry("#21", "int8_linear_gelu_quant fc, bn 512",
                partial(im.int8_linear_gelu_quant, xq, wq, xs, ws, bias),
                partial(im.int8_linear_gelu_quant_reference, xq, wq, xs, ws, bias),
                partial(torch._int_mm, xq, wq), "torch._int_mm alone",
                M * k + k * n + M * 4 + 2 * n * 4 + M * n + gs.numel() * 4, {"int8": 2 * M * k * n})
    _, w2q, _, w2s, b2 = _gemm_inputs(im, 8, n, k, seed=6)
    yield Entry("#20", "int8_linear_blockscale proj, 6 K blocks",
                partial(im.int8_linear_blockscale, gq, w2q, gs, w2s, b2),
                partial(im.int8_linear_blockscale_reference, gq, w2q, gs, w2s, b2),
                partial(torch._int_mm, gq, w2q), "torch._int_mm alone",
                M * n + n * k + gs.numel() * 4 + 2 * k * 4 + M * k * 2, {"int8": 2 * M * k * n})
    x, gamma, beta, _ = _producer_inputs(M, D, seed=7)
    yield Entry("#22", "ln_quantize", partial(im.ln_quantize, x, gamma, beta),
                partial(im.ln_quantize_reference, x, gamma, beta),
                partial(quant._ln_quant_rows, x, {"scale": gamma, "bias": beta}),
                "the xla tier's composition (quant._ln_quant_rows)",
                x.numel() * 2 + 2 * D * 4 + x.numel() + M * 4)


def _epilogue_inputs(n, seed=0):
    """int32 sums of a K=768 product [M, N] and a static site's scale, bias
    and inv_a in a calibrated tower's ranges."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    acc = torch.randint(-400_000, 400_000, (M, n), generator=g, device="cuda", dtype=torch.int32)
    return (acc, torch.rand((1, n), generator=g, device="cuda") * 2e-5 + 1e-6,
            torch.randn(n, generator=g, device="cuda") * 0.1,
            torch.rand((1, n), generator=g, device="cuda") * 40 + 10)


def _static(im) -> Iterator[Entry]:
    """#23, #25 and the static tower's epilogues at the vision shape: no one
    PyTorch call computes any of them (``torch.quantize_per_channel``, the
    nearest to ``row_quant_static``, divides by the scale, clips to
    [-128, 127] and takes no bf16)."""
    x, gamma, beta, inv_a = _producer_inputs(M, D, seed=1)
    producer = x.numel() * 2 + x.numel()
    yield Entry("#23", "ln_quantize_static", partial(im.ln_quantize_static, x, gamma, beta, inv_a),
                partial(im.ln_quantize_static_reference, x, gamma, beta, inv_a), None, "none",
                producer + 3 * D * 4)
    yield Entry("#25", "row_quant_static", partial(im.row_quant_static, x, inv_a),
                partial(im.row_quant_static_reference, x, inv_a), None, "none", producer + D * 4)
    yield Entry("epilogue", "ln_quant_folded", partial(im.ln_quant_folded, x, gamma, beta, inv_a),
                partial(im.ln_quant_folded_reference, x, gamma, beta, inv_a), None, "none",
                producer + 3 * D * 4)
    for name, n, gelu in (("static_requant (qkv)", 3 * D, None),
                          ("static_requant (fc, tanh GELU)", 4 * D, "tanh")):
        acc, scale, bias, a_inv = _epilogue_inputs(n)
        yield Entry("epilogue", name, partial(im.static_requant, acc, scale, bias, a_inv, gelu),
                    partial(im.static_requant_reference, acc, scale, bias, a_inv, gelu), None,
                    "none", acc.numel() * (4 + 1) + 3 * n * 4)
    acc, scale, bias, _ = _epilogue_inputs(D)
    res = _randn(M, D, dtype=BF16)
    yield Entry("epilogue", "static_residual (out)",
                partial(im.static_residual, acc, scale, bias, res),
                partial(im.static_residual_reference, acc, scale, bias, res), None, "none",
                acc.numel() * (4 + 2 + 2) + 2 * D * 4)


def _preprocess(pp) -> Iterator[Entry]:
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randint(0, 256, (B, 224, 224, 3), generator=g, device="cuda", dtype=torch.uint8)
    mean, std = torch.tensor(pp.CLIP_MEAN, device="cuda"), torch.tensor(pp.CLIP_STD, device="cuda")
    yield Entry("#26", f"normalize_uint8_kernel B={B} 224²", partial(pp.normalize_uint8_kernel, x),
                partial(pp.normalize_uint8_plain, x), lambda: (x.float() / 255.0 - mean) / std,
                "composition (x.float() / 255 - mean) / std", x.numel() * 5, {"f32": 2 * x.numel()})


def _gemm_probes(gp) -> Iterator[Entry]:
    """#27, #28 and #30 on their probes' own inputs and shapes."""
    from team_tpu_torch.scripts import int8_mxu_ceiling as mc
    from team_tpu_torch.scripts import int8_probe as ip
    from team_tpu_torch.scripts import r5_megakernel_probe as r5

    xs, w = ip.make_inputs(ip.SIZE, torch.device("cuda"))
    for tag, x, wt, lib, lib_name in (
            ("int8", xs[0], w, torch._int_mm, "torch._int_mm"),
            ("bf16", xs[0].to(BF16), gp.column_major(w.to(BF16)), torch.matmul,
             "torch.matmul (bf16 out)")):
        m, k = x.shape
        n = wt.shape[1]
        yield Entry(f"#27 {tag}", f"probe_mm {tag} M=N=K={m}", partial(gp.probe_mm, x, wt),
                    partial(gp.probe_mm_reference, x, wt), partial(lib, x, wt), lib_name,
                    (m * k + k * n) * x.element_size() + m * n * 4, {tag: 2 * m * n * k})
    del xs, w
    for dtype in (torch.int8, BF16):
        tag = "int8" if dtype == torch.int8 else "bf16"
        x, w = mc.make_inputs(dtype, mc.M, mc.K, torch.device("cuda"))
        yield Entry(f"#28 {tag}", f"mxu_ceiling {tag} M={mc.M} K=N={mc.K} REPS={mc.REPS}",
                    partial(gp.mxu_ceiling, x, w, mc.REPS, mc.M),
                    partial(gp.mxu_ceiling_reference, x, w, mc.REPS, mc.M), None, "none",
                    x.numel() * x.element_size() + w.numel() * w.element_size() + mc.M * mc.K * 4,
                    {tag: 2 * mc.M * mc.K * mc.K * mc.REPS})
    params, inputs = r5.make_inputs(r5.B, 1, torch.device("cuda"))
    x2 = inputs[0].reshape(-1, inputs[0].shape[-1])
    m, k = x2.shape
    n = params[0].shape[1]
    yield Entry("#30", f"mlp_mega_2d, a pair at B={r5.B}", partial(gp.mlp_mega_2d, x2, *params),
                partial(gp.mlp_mega_reference, x2, *params), partial(r5.xla_pair, x2, *params),
                "the torch composition (xla_pair)", m * k + 2 * k * n + m * k * 2 + (2 * n + k) * 4,
                {"int8": 4 * m * k * n})


def _tower_inputs(rows, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((rows, d), generator=g, device="cuda")
         * (torch.rand((rows, 1), generator=g, device="cuda") * 3 + 0.5)).to(BF16)
    y = torch.randn((rows, d), generator=g, device="cuda").to(BF16)
    b = (torch.randn(d, generator=g, device="cuda") * 0.1).to(BF16)
    return (x, y, b, torch.rand(d, generator=g, device="cuda") + 0.5,
            torch.rand(d, generator=g, device="cuda") * 0.4 - 0.2)


def _tower_bf16(tb) -> Iterator[Entry]:
    """The bf16 towers' elementwise kernels at ViT-B/16's and SigLIP's B=128
    sites; every byte in and out once. No one PyTorch call computes a bias
    with the GELU or a residual with the next layer norm; ``F.layer_norm``
    refuses a float32 affine with a bf16 input on the card, so it runs with
    gamma and beta rounded to bf16, a coarser function timed for speed only."""
    for tower, (m, d, f, eps, gelu) in (("vitb16", (B * S, D, 4 * D, 1e-5, "none")),
                                        ("siglip", (B * 729, 1152, 4304, 1e-6, "tanh"))):
        x, y, b, gamma, beta = _tower_inputs(m, d, seed=7)
        yf = _tower_inputs(m, f, seed=8)[1]
        bf = _tower_inputs(1, f, seed=9)[2]
        yield Entry(f"tower {tower}", f"bias_act fc, GELU {gelu}",
                    partial(tb.bias_act, yf, bf, gelu),
                    partial(tb.bias_act_reference, yf, bf, gelu), None, "none",
                    2 * yf.numel() * 2 + f * 2)
        yield Entry(f"tower {tower}", "residual_ln",
                    partial(tb.residual_ln, x, y, b, gamma, beta, eps),
                    partial(tb.residual_ln_reference, x, y, b, gamma, beta, eps), None, "none",
                    4 * x.numel() * 2 + 2 * d * 4 + d * 2)
        yield Entry(f"tower {tower}", "layer_norm", partial(tb.layer_norm, x, gamma, beta, eps),
                    partial(tb.layer_norm_reference, x, gamma, beta, eps),
                    partial(F.layer_norm, x, (d,), gamma.to(BF16), beta.to(BF16), eps),
                    "F.layer_norm, affine in bf16 (speed only)", 2 * x.numel() * 2 + 2 * d * 4)


def table() -> Iterator[Entry]:
    """Every entry, in PERF.md §6's order; each group's inputs are made when
    it is reached and dropped after it."""
    from team_tpu_torch.ops import flash_attention as fa
    from team_tpu_torch.ops import gemm_probe as gp
    from team_tpu_torch.ops import int8_matmul as im
    from team_tpu_torch.ops import mha_short as ms
    from team_tpu_torch.ops import preprocess as pp
    from team_tpu_torch.ops import tower_bf16 as tb

    for group in (partial(_packed, ms, fa), partial(_int8_attention, ms), partial(_fused, ms),
                  partial(_int8_gemms, im), partial(_static, im), partial(_preprocess, pp),
                  partial(_gemm_probes, gp), partial(_tower_bf16, tb)):
        yield from group()


def bound(entry: Entry, peaks: dict) -> tuple:
    """The least time the card could take, ms, and what sets it."""
    t_bytes = entry.nbytes / peaks["hbm_bytes_per_s"] * 1e3
    t_ops = sum(n / peaks[kind] * 1e3 for kind, n in entry.ops.items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_diff(out, ref) -> Optional[float]:
    """The largest |out − ref| over the tensors of two calls' results (int8
    in steps, bf16 and f32 as their values); None where they hold no tensor
    of one size."""
    outs, refs = ((out, ref) if isinstance(out, (tuple, list)) else ((out,), (ref,)))
    diffs = [(o.double().reshape(r.shape) - r.double()).abs().max().item()
             for o, r in zip(outs, refs) if isinstance(o, torch.Tensor)
             and isinstance(r, torch.Tensor) and o.numel() == r.numel() and o.numel()]
    return max(diffs) if diffs else None


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> list:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    peaks = json.loads(PEAKS.read_text())["cards"].get(name)
    if peaks is None:
        raise SystemExit(f"kernel_times: {PEAKS} holds no peaks for {name!r}")
    print(f"card: {card()}; torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off",
          flush=True)
    rows = []
    for entry in table():
        ref = entry.plain()
        err = max_abs_diff(entry.kernel(), ref)
        del ref
        p1, k1, k2, p2 = (spin_ms(fn) for fn in (entry.plain, entry.kernel, entry.kernel,
                                                 entry.plain))
        lib = spin_ms(entry.library) if entry.library is not None else None
        bound_ms, bound_by = bound(entry, peaks)
        ms = (k1 + k2) / 2
        row = {"row": entry.row, "label": entry.label, "ms": ms, "kernel_ms": [k1, k2],
               "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms,
               "plain_ms": (p1 + p2) / 2, "library": entry.library_name, "library_ms": lib,
               "max_abs_err": err}
        lib_text = f"{entry.library_name} {lib:.4f} ms" if lib is not None else "library none"
        print(f"{entry.row:>16} {entry.label}: card {k1:.4f}/{k2:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}, {100 * row['bound_share']:.1f} % of it), plain {p1:.4f}/{p2:.4f} ms, "
              f"{lib_text}, max |kernel - plain| {err}", flush=True)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
