"""Smoke run of the PyTorch/CUDA port (team_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, one line or more each:
  1. the card (nvidia-smi name and power limit); TF32 off for matmuls and cuDNN
  2. build the kernels from team_tpu_torch/csrc, one nvcc per source, all
     started together (set-up); ptxas's registers and spills of each
     kernel, no spill in a tensor-core kernel; cuobjdump -sass of
     attn_block.cu, mha_packed.cu and flash_attention.cu: HMMA in every
     tensor-core (bf16, *_tc) kernel (#4's mha_v2_kernel_tc in its PV), none
     in the CUDA-core ones (f32); of int8_gemm.cu and gemm_probe.cu: GMMA
     (IGMMA s8, HGMMA bf16) in the wgmma + TMA kernels (#15 gemm_kernel_wg,
     #20 blockscale_kernel_wg, #21 gelu_quant_kernel_wg, #27
     probe_mm_kernel_wg_s8 and probe_mm_kernel_wg, #28 ceiling_kernel_wg in
     both forms, #30 mlp_mega_kernel_wg), none in the mma.sync ones, and no
     spill in them;
     of mha_packed_q3i.cu: IMMA (q.k) and HMMA
     (p.v) in q3i_kernel_tc (#7, #10, #11, #29; #29's qkonly and nopv, its
     6 instantiations with no PV, IMMA alone), neither in q3i_cls_kernel
     (the CLS entries #8, #9), no spill in either; of
     mha_packed_q.cu: HMMA in mha_q_kernel_tc (#5, #6); no spill in them
     either; the mnemonics by kernel
  3. each kernel vs its plain PyTorch version at the main paths' shapes: the
     packed attention in bf16 and f32; the int8 integer-QK^T attention and
     its CLS-query variant (static and row-max softmax, causal, kv_len), at
     most one int8 step apart with under 1 % of the outputs differing, the
     integer-QK^T kernel's other modes (exp2i, reduce, reduce with the
     deferred divide, the int8 PV with and without it; the int8 PV also
     allowed what one p8 flipped at a rounding edge moves an output by) at
     the vision shape and masked shapes, the split CLS-query kernel equal to
     the CLS kernel bit for bit and the sequence-major kernel equal to the
     packed one on the transposed rows bit for bit; the
     int8-I/O attention (f32 and bf16 dequant) at the vision shape and
     causal/kv_len shapes and the layer norm -> int8 producer, to the same
     limit, and the static quantize bit for bit; the flash attention at the
     vision shape (bf16, f32), the text shape (causal, kv_len) and S=577,
     where the auto route takes it; the fused out-projection
     (mha_packed_proj) and attention sub-block (attn_block) at the vision and
     text shapes and the pre-split attention (mha_short, kv_len = S and < S)
     at the vision shape, bf16 and f32, with non-zero biases and layer-norm
     affines; the int8 GEMMs of the dynamic tiers at the vision tower's shapes
     and at the gate batch's ragged M (3,152 rows): int8_linear at qkv
     768->2304 and out 768->768 (bf16 and f32, with and without the GELU,
     within one bf16 step; the [N, K] entry bit for bit; its wgmma kernel
     also bit for bit the mma.sync kernel), gelu_quant at fc
     768->3072 (bn 512; its wgmma kernel also bit for bit the mma.sync
     kernel, q and s) and the dynamic layer norm -> int8 at most one int8
     step apart on under 1 % of the outputs with scales within 1e-6, the
     block-scale GEMM at proj 3072->768 (6 K blocks; its wgmma kernel also
     bit for bit the mma.sync kernel), and the 3-D static
     producer bit for bit the 2-D one; the tensor-parallel head splits at
     nm 2 and 4: each rank of fused_mha_packed_tp (vision and causal text,
     bf16 and f32) and of fused_mha_packed_q3i_tp (the vision shape in every
     mode of the q3i kernel, the causal text shape) against its plain
     version, and the ranks side by side against the whole-head kernels bit
     for bit; the v2 pre-split attention (#4) at the vision shape in bf16 and
     f32, both exp dtypes, every key and kv_len < S (f32 within 1e-5, bf16
     within two bf16 steps of |ref| plus one of its row's largest |ref| plus
     1e-5; bf16 also within one bf16 step, plus the f32 order bound, of the
     CUDA-core kernel it replaced, the count of outputs that differ printed),
     and on bf16 inputs its two
     switches shown to take effect (deferred normalise against #3, bf16 exp
     against f32 exp); each q3i decomposition variant (#29) on the probe's
     inputs at B=128 with o_inv 20-60 and 0.5-2, one int8 step on under 1 %
     (copy bit for bit; the float outputs checked finite first); the probe
     paths' kernels at the probes' own shapes and inputs (B=256): #3 and each
     #4 implementation of attn_shootout on its first two layers' inputs (as
     v2), each #29 variant on r4_attn_decomp's first layer; the u8
     normalize (#26) bit for bit over every u8 value and at B=128, 224^2;
     the GEMM probes' kernels at the probes' own shapes and inputs:
     probe_mm (#27) int8 bit for bit the exact product over a whole 4096^3
     input, and bf16 within (K/16 + 1) ulps of |x|@|w|, mxu_ceiling (#28)
     int8 bit for bit and bf16 within 2^-10 of the largest |ref|, each
     equal bit for bit over two launches, mlp_mega
     (#30) 2-D and 3-D bit for bit and within 127 s2 per near-edge hq (plus
     one bf16 step) of the plain version, the share of rows that differ
     printed; the backwards of #1, #3, #13 and #14 (their autograd
     Functions: the kernel's forward, a recompute of the plain attention
     differentiated) at the towers' shapes (vision B=8, S=197, H=12; text
     S=77, H=8, causal; #3 the image tower only), f32 and bf16, against
     autograd of their plain references (the gradients of sum(tanh(out)·w)
     within 1e-4 of their max in f32, 2e-2 in bf16), each kernel launched
     once a forward; and #12 refusing an input that requires grad; the bf16
     towers' elementwise kernels (csrc/tower_bf16.cu) against the
     compositions they replace at ViT-B/16's, SigLIP's (B=128) and the text
     tower's (32 prompts) sites: bias_act at the qkv bias and the fc bias
     with the tower's GELU and residual_ln's x' bit for bit, the layer norms
     (residual_ln's, layer_norm's, also on the CLS rows x[:, 0] and the
     attention-pool head's 128 rows) one bf16 step on under 0.1 %
  4. kernels, plain versions (plain, kernel, kernel, plain) and
     scaled_dot_product_attention as the library yardstick (for the fused
     kernels a composition of PyTorch calls; for the int8 GEMMs torch._int_mm
     alone and the xla tier's composition; for the head split SDPA on the
     rank's head views, one rank's launch timed), timed with CUDA
     events over calls queued behind a device spin (device time, not the
     host's launch rate); each kernel's bound (bytes over 3.35 TB/s or operations over the
     peak of their type) computed from the same inputs; #4 (f32 and bf16 exp)
     against SDPA and the CUDA-core kernel it replaced, with its design's FMA
     floor beside the byte bound, #29's variants (copy against qkv[..., :D].contiguous()),
     #26 with the torch composition of its arithmetic as context, the static
     tower's epilogue kernels against the compositions they replace; #27
     against torch._int_mm and torch.matmul (bf16 out), #28 with none (its
     rate is the wgmma ceiling, printed as a share of the dense peak), #30
     against the torch composition; the bf16 towers' elementwise kernels
     (bias_act with the GELU, residual_ln with the layer norm, layer_norm) at
     ViT-B/16's and SigLIP's B=128 sites against their compositions and
     their HBM bounds (each byte in and out once); the
     fused kernels' TFLOP/s and share of their bound beside their times; the
     tensor-core attention kernels (#1-#4, #14) against the CUDA-core
     kernels' ms of PERF.md, SDPA (the factor) and the bound (its share);
     the wgmma GEMMs (#15 at qkv and out, #20 at proj, #21 at fc, #27 int8
     and bf16) against their mma.sync ms of PERF.md, the library call, the
     bound (its share) and TOP/s or TFLOP/s; the kernels redesigned last
     (#8 and #9 streaming on cp.async, #30 and #28 on wgmma + TMA) against
     their earlier ms of PERF.md and the bound (its share)
  5. the main paths through team_tpu_torch.trainer.train at full ViT-B/16
     width, random init, each with the counts zeroed just before its run and
     read just after: SimpleCIL (bf16) and ZS-CLIP (f32), whose packed
     attention launches must be non-zero for causal (text) and non-causal
     (vision) calls; SimpleCIL on the int8 static tier, which must commit
     the quantized tower (a fallback to bf16 fails) with 11 q3i and one
     q3i_cls launch per int8 batch, and 24 of each static epilogue kernel
     (layer norm -> int8, requantize, residual); the same on int8_gemm_impl static_qa,
     static, static3d_qaf, static3d_qis and static3d_qi with
     TEAM_CLS_LAST=kqs, each with its own payload cache, whose kernel
     launches must equal their counts per int8 batch (24 layer norm -> int8
     and 12 int8-I/O attention on static_qa; 24 layer norm -> int8, 12
     static quantize and 12 packed on static; 12 int8-I/O attention with
     the bf16 dequant on static3d_qaf; 12 sequence-major on static3d_qis;
     11 q3i and 1 split CLS on kqs, no CLS; and each route's static
     epilogue kernels, STATIC3D_EPILOGUES on the static3d routes); PROOF (bf16) with attention_impl
     "pallas", two tasks of tuned_epoch 2 at batch 16, whose flash launches
     must be non-zero in both towers; then PROOF's loss on a batch of its
     own features on the card against the CPU, a profiled train step, and in
     a fresh process the cost of importing torch._dynamo (what the first
     torch.optim construction pays); PROOF (bf16) on attention_impl
     "attn_block", SimpleCIL (bf16) on "mha_packed_proj" and ZS-CLIP (f32) on
     "attn_block", whose fused launches must equal the layers times the
     image-tower (non-causal) and text-tower (causal) calls, with no packed
     or flash launch; SimpleCIL (bf16) on the dynamic tiers int8_gemm_impl
     hybrid and pallas at batch 16, each with its own payload cache, whose
     gate on the static payload must decide by the >= 0.999 rule and the run
     serve what it decided, with each of the tier's kernels launched exactly
     its count per block of each int8 batch (pallas: 2 ln_quantize, 2
     int8_linear, 1 gelu_quant, 1 blockscale; hybrid: 2, 0, 1, 1); the
     parallel paths: PROOF (bf16, batch 16) in a world of one rank over NCCL
     with mesh_shape [1] and [1, 1], whose curves must equal the run without
     a mesh, then two ranks spawned on the one card (this script with
     --parallel-worker; gloo, CUDA tensors staged through the host): PROOF
     data parallel on mesh_shape [2] through the trainer (curves equal, loss
     components within 1e-3 relative of the single process), the bf16 image
     tower at B=128 under a [1, 2] layout on mha_packed_tp (weights split by
     shard_clip_params; one head-split launch a block; features against one
     device's, cosine >= 0.999) and the int8 static3d_qi tower under it
     (q3i attention through fused_mha_packed_q3i_tp, 12 launches an int8
     encode, the ranks' gates identical and committed, features against one
     device's on the same payload); the probe entry points, each with the
     counts zeroed before it: team_tpu_torch.scripts.attn_shootout (MODE all,
     then qpad128; B=256) must launch #4, team_tpu_torch.scripts.r4_attn_decomp
     (B=256) every #29 variant, and #26 through the library API at B=128 once;
     the GEMM probes at their own shapes, each with the counts zeroed before
     it: team_tpu_torch.scripts.int8_probe must launch #27, int8_mxu_ceiling
     #28, r5_megakernel_probe both entries of #30;
     SigLIP So400m/14-384 (bf16, auto) through BackboneRuntime: one B=128
     encode with 28 flash calls and, as ViT-B/16's bf16 B=128 encode, the
     bf16 elementwise kernels' launches of TOWER_BF16_LAUNCHES (ViT-B/16's
     features also against the same tower with the kernels switched off,
     cosine >= TOWER_COS);
     Grad-CAM at full ViT-B/16 width (random init, B=4, f32) on auto (#1),
     mha_short (#3), attn_block (#13) and pallas (#14) against the plain
     route, the [0, 1] maps within 1e-3 and the route's kernel launched once
     a layer; PROOF (bf16, batch 16, tuned_epoch 2) with checkpoint_dir run
     whole, then its last task's file deleted and resumed: the curves equal
     bit for bit; team_tpu_torch.scripts.full_protocol in a fresh process
     (this script with --full-protocol): PROOF in bf16, ten tasks at the
     flagship's shape, equal to its committed golden and above its floor,
     with its wall time, phase sums and the busy share of one profiled
     epoch;
     then the repairs: the bicubic resize on the card against the CPU (32->224
     up, 256x320->224 down, within 1e-5) and the open_clip loader at ViT-B/16
     width (a seeded synthetic .npz through TEAM_CLIP_CHECKPOINT; the tree
     equal to the source arrays, the runtime and one encode equal to
     params=, and FileNotFoundError without allow_byte_tokenizer)
  6. features against the plain-attention towers (packed and flash routes)
     and against the bf16 tower on a small batch, each int8 route against
     itself with the plain versions of its kernels (same payload, same card;
     static3d_qi also with those of its attention kernels alone, the static
     epilogue kernels on both sides), every int8 kernel call also held
     against its plain version on the tower's own inputs;
     static3d and static3d_qa served from the payloads saved on static and
     static_qa, and static3d_qib, static3d_qi2 (also with TEAM_QI_DEFER=1),
     the CLS modes mlp and attn and static3d_qi under TEAM_QI_SOFTMAX=exp2i,
     TEAM_QI_ROWSUM=reduce and reduce with TEAM_QI_DEFER=1 from the one
     saved on static3d_qi, with the q3i kernels' launches in one encode
     exact; the dynamic xla tier on its own payload (library API) against
     its plain attention; both towers on attn_block and mha_packed_proj and the image
     tower on mha_short against the same towers through the plain versions
     of their kernels; the image-encode rates at the eval batch (bf16, f32,
     int8 on each route, bf16 through flash, bf16 and f32 on attn_block,
     mha_packed_proj and mha_short); hybrid and pallas through the library API
     on the dynamic payload at full width (every kernel call held against its
     plain version on the tower's inputs, launches per encode exact, features
     against the plain versions and the bf16 tower, encode rates, beside
     their rates with #21 on mma.sync and with #15 and #20 on it), and the
     int8 text tower on the class prompts (xla, hybrid and pallas on the
     dynamic text payload, static3d_qi on the prompt-set payload) against
     the bf16 text tower and against itself with the plain versions
  7. a torch.profiler split of one B=128 encode: int8 (static3d_qi,
     static_qa and static3d_qis), the int8 pallas tier, bf16, bf16 through
     flash, bf16 on attn_block and on mha_packed_proj
Then the script's total time, one JSON line of kernel results, and last the
JSON status line.
Any failure raises, and the script exits non-zero without the status line.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

MAIN_SHAPES = {  # (batch, seq, heads, causal) of the two towers at their batch sizes
    "vision": (128, 197, 12, False),
    "text": (32, 77, 8, True),
}
TOL = {"torch.float32": 1e-5, "torch.bfloat16": 2e-2}  # as in tests/test_torch_mha_packed.py
SOURCES = ("mha_packed.cu", "attn_block.cu", "mha_packed_q3i.cu", "flash_attention.cu",
           "mha_packed_q.cu", "int8_quant.cu", "int8_gemm.cu", "preprocess.cu", "gemm_probe.cu",
           "tower_bf16.cu")
# flash attention: (batch, heads, seq, causal, kv_len, head width); vision
# and text are the towers' shapes on the main path, S=577 a shape the auto
# route sends to it, siglip SigLIP So400m/14-384's blocks at the learners'
# batch (head width 72, bf16 only)
FLASH_SHAPES = {"vision": (128, 12, 197, False, None, 64), "text": (32, 8, 77, True, 77, 64),
                "s577": (8, 12, 577, False, None, 64), "siglip": (128, 16, 729, False, None, 72)}
# the H100 SXM's published peaks (NVIDIA's data sheet, dense rates; "f32" is the
# float32 rate outside the tensor cores, which is what a float32 product with
# TF32 off gets); they assume 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
# the block-level fused routes; a residual makes their outputs up to ~5, where
# one bf16 step is 0.03, so bf16 is held to TOL plus one step (2^-7) of |ref|
FUSED_ROUTES = ("attn_block", "mha_packed_proj")
BF16_STEP = 2.0 ** -7
INT8_MAX_FRAC = 0.01  # int8 kernels: at most one int8 step, and under 1 % of outputs differing
EPILOGUE_MAX_FRAC = 0.001  # the static epilogues with a GELU and ln_quant_folded: under 0.1 %
def STATIC3D_EPILOGUES(n: int) -> dict:
    """The static epilogues of a static3d route's n-layer tower, per int8
    batch: two layer norms to int8, two requantizes (qkv, fc) and two
    residual epilogues (out, proj) a block."""
    return {"ln_quant_folded": 2 * n, "static_requant": 2 * n, "static_residual": 2 * n}


# the int8 runs besides static3d_qi that phase 5 makes: name -> (int8_gemm_impl,
# knobs, each kernel's launches per int8 batch of an L-layer tower: 24 and 12
# on static_qa; 24, 12 and 12 on static; 12 on static3d_qaf; 12 sequence-major
# on static3d_qis; 11 q3i and one split CLS kernel on static3d_qi with
# TEAM_CLS_LAST=kqs; and the static epilogues: a requantize after each int8-out
# GEMM, a bf16 epilogue after each bf16-out one (the out and proj GEMMs with
# the residual), _ln_quant3's kernel for each layer norm that it produces)
INT8_ROUTES = {
    "static_qa": ("static_qa", {}, lambda n: {"ln_quantize_static": 2 * n,
                                              "fused_mha_packed_q": n, "static_requant": 2 * n,
                                              "static_residual": 2 * n}),
    "static": ("static", {}, lambda n: {"ln_quantize_static": 2 * n, "row_quant_static": n,
                                        "fused_mha_packed": n, "static_requant": n,
                                        "static_residual": 3 * n}),
    "static3d_qaf": ("static3d_qaf", {}, lambda n: {"fused_mha_packed_q3": n,
                                                    **STATIC3D_EPILOGUES(n)}),
    "static3d_qis": ("static3d_qis", {}, lambda n: {"fused_mha_packed_q3i_sb": n,
                                                    **STATIC3D_EPILOGUES(n)}),
    "kqs": ("static3d_qi", {"TEAM_CLS_LAST": "kqs"},
            lambda n: {"fused_mha_packed_q3i": n - 1, "fused_mha_packed_q3i_cls_split": 1,
                       **STATIC3D_EPILOGUES(n), "static_requant": 2 * n + 1}),
}
# the configurations phase 6 serves from the payload that phase 5 saved on
# another run (a payload holds every static route's keys): name -> (the run
# whose cache it loads, int8_gemm_impl, knobs, each q3i kernel's launches per
# encode of an L-layer tower, or None where phase 5 counted them)
SERVED = {
    "static3d": ("static", "static3d", {}, None),
    "static3d_qa": ("static_qa", "static3d_qa", {}, None),
    "static3d_qib": ("static3d_qi", "static3d_qib", {},
                     lambda n: {"fused_mha_packed_q3i": n - 1, "fused_mha_packed_q3i_cls": 1}),
    "static3d_qi2": ("static3d_qi", "static3d_qi2", {}, lambda n: {"fused_mha_packed_q3i": n}),
    "static3d_qi2_defer": ("static3d_qi", "static3d_qi2", {"TEAM_QI_DEFER": "1"},
                           lambda n: {"fused_mha_packed_q3i": n}),
    "mlp": ("static3d_qi", "static3d_qi", {"TEAM_CLS_LAST": "mlp"},
            lambda n: {"fused_mha_packed_q3i": n}),
    "attn": ("static3d_qi", "static3d_qi", {"TEAM_CLS_LAST": "attn"},
             lambda n: {"fused_mha_packed_q3i": n - 1}),
    "exp2i": ("static3d_qi", "static3d_qi", {"TEAM_QI_SOFTMAX": "exp2i"},
              lambda n: {"fused_mha_packed_q3i": n - 1, "fused_mha_packed_q3i_cls": 1}),
    "reduce": ("static3d_qi", "static3d_qi", {"TEAM_QI_ROWSUM": "reduce"},
               lambda n: {"fused_mha_packed_q3i": n - 1, "fused_mha_packed_q3i_cls": 1}),
    "reduce_defer": ("static3d_qi", "static3d_qi", {"TEAM_QI_ROWSUM": "reduce",
                                                    "TEAM_QI_DEFER": "1"},
                     lambda n: {"fused_mha_packed_q3i": n - 1, "fused_mha_packed_q3i_cls": 1}),
}
Q3I_COUNTERS = ("fused_mha_packed_q3i", "fused_mha_packed_q3i_cls",
                "fused_mha_packed_q3i_cls_split", "fused_mha_packed_q3i_sb")
# the q3i kernel's modes besides the default: name -> (knobs, wrapper arguments)
Q3I_MODES = {
    "exp2i": ({"TEAM_QI_SOFTMAX": "exp2i"}, {}),
    "reduce": ({"TEAM_QI_ROWSUM": "reduce"}, {}),
    "reduce_defer": ({"TEAM_QI_ROWSUM": "reduce"}, {"defer_norm": True}),
    "pv_int8": ({}, {"pv_int8": True}),
    "pv_int8_defer": ({}, {"pv_int8": True, "defer_norm": True}),
}
# the phase-6 configuration whose encodes count each mode's launches
MODE_SERVED = {"exp2i": "exp2i", "reduce": "reduce", "reduce_defer": "reduce_defer",
               "pv_int8": "static3d_qi2", "pv_int8_defer": "static3d_qi2_defer"}
# the int8 GEMMs of the vision tower's blocks on the dynamic tiers, (K, N)
GEMM_SHAPES = {"qkv": (768, 2304), "out": (768, 768)}
FC_SHAPE, PROJ_SHAPE = (768, 3072), (3072, 768)
# the dynamic tiers' kernels (int8_matmul wrappers) and their calls per block
TIER_PER_BLOCK = {
    "hybrid": {"ln_quantize": 2, "int8_linear": 0, "int8_linear_gelu_quant": 1,
               "int8_linear_blockscale": 1},
    "pallas": {"ln_quantize": 2, "int8_linear": 2, "int8_linear_gelu_quant": 1,
               "int8_linear_blockscale": 1},
}
TIER_KERNELS = tuple(TIER_PER_BLOCK["pallas"])
# the dynamic tiers' encode rates with #21 on mma.sync, before it moved to
# wgmma (PERF.md §5: this script's phase 6 on an NVIDIA H100 80GB HBM3 at
# 700.00 W), img/s
MMA_SYNC_TIER_RATES = {"hybrid": 2780.4, "pallas": 3648.8}
# the same with #15 and #20 on mma.sync, #21 on wgmma: the spread of three
# runs (PERF.md §7), img/s
GEMM_MMA_SYNC_TIER_RATES = {"hybrid": (3300.3, 3402.0), "pallas": (4483.9, 4790.3)}
# the int8 static routes' encode rates before their attention moved to the
# tensor cores (PERF.md §5: this script's phase 6 on an NVIDIA H100 80GB HBM3
# at 700.00 W), img/s by phase-6 key
INT8_CUDA_CORE_RATES = {"int8_static": 1664.6, "int8_static_static_qa": 1766.7,
                        "int8_static_static": 2557.3, "int8_static_static3d": 1808.0,
                        "int8_static_static3d_qa": 1423.6, "int8_static_static3d_qaf": 1465.6,
                        "int8_static_static3d_qis": 1557.2}
DATASET = {"num_classes": 4, "img_size": 224, "train_per_stage": 64, "test_per_stage": 32}
EVAL_B = 128  # the learners' eval batch
# the learner batch of exps/IIMinsects202.json: the int8 run calibrates on its
# first batch and gates on the second, both from one class and stage of the
# synthetic set (each class, stage and split has its own colour, so a
# calibration batch of one colour does not cover the next colour: the gate
# then falls back, in team_tpu as here)
FLAGSHIP_BATCH = 16
# the rows of a batch of 16 at S=197: the gate batch's, no multiple of a kernel tile
RAGGED_M = FLAGSHIP_BATCH * 197


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def knobs(env: dict):
    """The environment variables of ``env`` set for the block, then restored
    (the port reads its knobs at each call)."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _time_ms(fn, iters: int = 20) -> float:
    """Device time per call of ``fn`` over ``iters`` calls. The card first
    spins for some 20 ms, so that the host has queued every call before the
    start event: the time is the device's, not the host's launch rate (a
    kernel of 0.03 ms launches slower than it runs)."""
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)  # cycles, about 20 ms at the H100's clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops_by_type: dict) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS_PER_S[kind] * 1e3 for kind, n in ops_by_type.items())
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def attention_ops(b: int, h: int, s: int, dh: int, causal: bool, rows: int = None) -> int:
    """Multiply-adds of QK^T and PV, two operations each: 4·B·H·(query,
    key pairs)·dh; a causal mask needs the lower triangle only."""
    pairs = s * (s + 1) // 2 if causal else (rows or s) * s
    return 4 * b * h * pairs * dh


def sdpa_ms(q, k, v, causal: bool) -> float:
    """One PyTorch call that computes the same attention (the yardstick;
    the port never calls it)."""
    import torch.nn.functional as F

    return _time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))


def compare_kernel(ms, dev) -> float:
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    cases = [(*MAIN_SHAPES["vision"], None), (*MAIN_SHAPES["text"], None),
             (32, 197, 12, False, 150), (32, 77, 8, True, 60)]
    for b, s, h, causal, kv_len in cases:
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn((b, s, 3 * h * 64), generator=gen, device=dev).to(dtype)
            out = ms.fused_mha_packed(qkv, h, causal=causal, kv_len=kv_len)
            ref = ms.mha_packed_reference(qkv, h, causal, kv_len)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = TOL[str(dtype)]
            print(f"  B={b} S={s} H={h} causal={causal} kv_len={kv_len} {dtype}: "
                  f"max_abs_err={err:.3e} (tol {tol:g})")
            if not math.isfinite(err) or err > tol:
                raise AssertionError(f"kernel disagrees with its plain version: {err} > {tol}")
            worst = max(worst, err)
    return worst


def time_kernel(ms, dev) -> dict:
    import torch

    gen = torch.Generator(device=dev).manual_seed(1)
    times = {}
    for tower, (b, s, h, causal) in MAIN_SHAPES.items():
        qkv = torch.randn((b, s, 3 * h * 64), generator=gen, device=dev).to(torch.bfloat16)
        kernel = lambda: ms.fused_mha_packed(qkv, h, causal=causal)  # noqa: E731
        plain = lambda: ms.mha_packed_reference(qkv, h, causal)  # noqa: E731
        p1, k1, k2, p2 = _time_ms(plain), _time_ms(kernel), _time_ms(kernel), _time_ms(plain)
        q, k, v = (t.reshape(b, s, h, 64).transpose(1, 2) for t in qkv.split(h * 64, dim=-1))
        lib = sdpa_ms(q, k, v, causal)
        times[tower] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib,
                        **bound(qkv.numel() * 2 + b * s * h * 64 * 2,
                                {"bf16": attention_ops(b, h, s, 64, causal)})}
        print(f"  packed {tower} B={b} S={s} H={h} causal={causal} bf16: kernel {k1:.4f}/{k2:.4f} ms, "
              f"plain {p1:.4f}/{p2:.4f} ms, scaled_dot_product_attention {lib:.4f} ms, "
              f"bound {times[tower]['bound_ms']:.4f} ms ({times[tower]['bound_by']})")
    return times


# the attention sources whose bf16 kernels run on the tensor cores (mma.sync;
# #4's bf16 kernel its PV alone) and whose f32 kernels run on the CUDA cores:
# source -> (tensor-core kernels, CUDA-core kernels), by name (a tensor-core
# name, *_tc, holds its CUDA-core kernel's name, so it is matched first)
TC_SOURCES = {
    "attn_block.cu": (("mha_packed_proj_kernel_tc", "ln_qkv_kernel_tc"),
                      ("mha_packed_proj_kernel", "ln_qkv_kernel")),
    "mha_packed.cu": (("mha_packed_kernel_tc", "mha_v2_kernel_tc"), ("mha_packed_kernel",)),
    "flash_attention.cu": (("flash_kernel_tc",), ("flash_kernel",)),
    # the int8 attention: #7's kernel (p.v; also #10, #11, #29) and #5/#6's;
    # the CLS entries (#8, #9) run on the CUDA cores, bound by their bytes
    "mha_packed_q3i.cu": (("q3i_kernel_tc",), ("q3i_cls_kernel",)),
    "mha_packed_q.cu": (("mha_q_kernel_tc",), ()),
}

# the int8 attention kernels whose q.k runs on the s8 tensor cores (mma.sync
# m16n8k32, IMMA.16832.S8.S8) and the CLS kernel, which issues none
IMMA_SOURCES = {
    "mha_packed_q3i.cu": (("q3i_kernel_tc",), ("q3i_cls_kernel",)),
}

# the tensor-core kernels of TC_SOURCES some of whose instantiations run no
# PV, so issue no HMMA: source -> kernel -> how many (#29's qkonly and nopv
# at 3 head widths, q3i_kernel_tc's VAR kQkOnly and kNoPv)
NO_PV_INSTANCES = {"mha_packed_q3i.cu": {"q3i_kernel_tc": 6}}


# the GEMM sources whose wgmma kernels (TMA-fed, csrc/wgmma_gemm.cuh) issue
# GMMA instructions and whose mma.sync kernels issue none: source -> (wgmma
# kernels, mma.sync kernels), by name as TC_SOURCES (cuobjdump prints
# IGMMA.64x256x32.S8.S8 for the s8 m64n256 forms (#15, #21, #27 and #28
# int8), IGMMA.64x128x32.S8.S8 for #20's and #30's m64n128 and
# HGMMA.64x256x16.F32.BF16 for #27's and #28's bf16 ones; mma.sync is
# IMMA.16832.S8.S8 and HMMA.16816.F32.BF16)
GMMA_SOURCES = {
    "int8_gemm.cu": (("gelu_quant_kernel_wg", "gemm_kernel_wg", "blockscale_kernel_wg"),
                     ("gelu_quant_kernel", "gemm_kernel")),
    "gemm_probe.cu": (("probe_mm_kernel_wg_s8", "probe_mm_kernel_wg", "mlp_mega_kernel_wg",
                       "ceiling_kernel_wg"), ()),
}


def check_tensor_cores(build, sources=TC_SOURCES, opcode="HMMA", without=None) -> dict:
    """``opcode`` instructions in each kernel of the built libraries
    (``cuobjdump -sass``): HMMA in the attention sources, where every
    tensor-core (bf16) kernel issues its products on the tensor cores and no
    CUDA-core kernel (f32) does; GMMA in the GEMM sources, where every wgmma
    kernel issues it and no mma.sync kernel does; IMMA in the int8 attention
    kernel whose q.k runs on the tensor cores. ``without`` (source -> kernel
    -> n) names the tensor-core kernels of which exactly n instantiations
    issue no ``opcode``. Prints the mnemonics that hold ``opcode``, by
    kernel. Returns source -> kernel -> the count of each of its
    instantiations."""
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    found = {}
    for source, (tc, other) in sources.items():
        sass = subprocess.run([cuobjdump, "-sass", str(build._target(source))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        counts = {}
        mnemonics = defaultdict(set)
        name = None
        for line in sass.splitlines():
            if "Function :" in line:
                name = line.split("Function :")[1].strip()
                counts[name] = 0
            elif name is not None and opcode in line:
                counts[name] += 1
                mnemonics[name].update(re.findall(rf"\b\w*{opcode}[.\w]*", line))
        kinds = defaultdict(list)
        kind_mnemonics = defaultdict(set)
        for fn, n in counts.items():
            kind = next((k for k in tc if k in fn), None) or next(
                (k for k in other if k in fn), None)
            if kind is not None:
                kinds[kind].append(n)
                kind_mnemonics[kind] |= mnemonics[fn]
        print(f"  cuobjdump -sass {source}, {opcode} per kernel: {dict(kinds)}; mnemonics "
              f"{ {k: sorted(m) for k, m in kind_mnemonics.items() if m} }")
        exempt = (without or {}).get(source, {})
        if any(not kinds[k] or kinds[k].count(0) != exempt.get(k, 0) for k in tc):
            raise AssertionError(f"a kernel of {source} that should issue {opcode} does not: "
                                 f"{dict(kinds)}")
        if any(not kinds[k] or max(kinds[k]) > 0 for k in other):
            raise AssertionError(f"a kernel of {source} is missing or issues {opcode}: "
                                 f"{dict(kinds)}")
        found[source] = dict(kinds)
    return found


# the CUDA-core kernels redesigned for their bytes, which may not spill
# either: source -> kernels (#8/#9's CLS kernel)
NO_SPILL_CUDA_CORE = {"mha_packed_q3i.cu": ("q3i_cls_kernel",)}


def check_no_spills(build) -> None:
    """Raise if ptxas reported a spill in a tensor-core kernel (mma.sync or
    wgmma) or one of NO_SPILL_CUDA_CORE, or serialized a kernel's wgmma
    (C7514: accumulators read while their group may be in flight; phase 2
    prints every kernel's registers). A library loaded from an earlier build
    has no report in this process."""
    checked = defaultdict(set)  # source -> the kernels that may not spill
    for table in (TC_SOURCES, GMMA_SOURCES, IMMA_SOURCES):
        for source, (tc, _) in table.items():
            checked[source].update(tc)
    for source, kernels in NO_SPILL_CUDA_CORE.items():
        checked[source].update(kernels)
    for source, tc in checked.items():
        log = build.BUILD_LOGS.get(source)
        if log is None:
            print(f"  ptxas {source}: no report in this process (built before)")
            continue
        name = None
        for line in log.splitlines():
            if "C7514" in line:
                raise AssertionError(f"{source}: ptxas serialized a kernel's wgmma ({line.strip()})")
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif name is not None and any(k in name for k in tc):
                spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", line)]
                if any(spills):
                    raise AssertionError(f"{source}: {name} spills ({line.strip()})")


def fused_inputs(b, s, h, dtype, dev, seed=0, dh=64):
    """x, a layer norm's affine, the attention's weights and biases (biases and
    affine non-zero: the random init makes them 0 and 1), and a packed qkv."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    d = h * dh

    def randn(*shape, std=1.0, mean=0.0):
        return torch.randn(shape, generator=g, device=dev) * std + mean

    return {"x": randn(b, s, d).to(dtype), "ln": (randn(d, std=0.3, mean=1.0), randn(d, std=0.2)),
            "attn": (randn(d, 3 * d, std=d ** -0.5).to(dtype), randn(3 * d, std=0.5),
                     randn(d, d, std=d ** -0.5).to(dtype), randn(d, std=0.5)),
            "qkv": randn(b, s, 3 * d).to(dtype)}


def _fused_calls(ms, inp, h, causal):
    """(kernel, plain) of the two fused kernels on ``fused_inputs``."""
    x, ln, attn, qkv = inp["x"], inp["ln"], inp["attn"], inp["qkv"]
    return {
        "fused_mha_packed_proj": (
            lambda: ms.fused_mha_packed_proj(qkv, attn[2], attn[3], x, h, causal=causal),
            lambda: ms.mha_packed_proj_reference(qkv, attn[2], attn[3], x, h, causal)),
        "fused_attn_block": (
            lambda: ms.fused_attn_block(x, *ln, *attn, h, causal=causal),
            lambda: ms.attn_block_reference(x, *ln, *attn, h, causal)),
    }


def _check_close(name: str, out, ref, dtype) -> float:
    """max |out - ref|; raises past TOL (bf16: plus one bf16 step of |ref|)."""
    import torch

    err = (out.float() - ref.float()).abs()
    tol = TOL[str(dtype)]
    limit = tol + (BF16_STEP * ref.float().abs() if dtype == torch.bfloat16 else 0.0)
    worst = err.max().item()
    rule = f"{tol:g}" + (" + 2^-7 |ref|" if dtype == torch.bfloat16 else "")
    print(f"  {name} {dtype}: max_abs_err={worst:.3e} (tol {rule})")
    if out.shape != ref.shape or not math.isfinite(worst) or bool((err > limit).any()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return worst


def compare_fused(ms, dev) -> dict:
    """The fused out-projection and attention sub-block kernels at the vision
    and text shapes, and the pre-split kernel at the vision shape (kv_len = S
    and < S), bf16 and f32, against their plain versions."""
    import torch

    worst = dict.fromkeys(("fused_mha_packed_proj", "fused_attn_block", "fused_mha_short"), 0.0)
    for tower, (b, s, h, causal) in MAIN_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            inp = fused_inputs(b, s, h, dtype, dev)
            for name, (kernel, plain) in _fused_calls(ms, inp, h, causal).items():
                out = kernel()
                ref = plain()
                torch_sync()
                worst[name] = max(worst[name], _check_close(
                    f"{name} {tower} B={b} S={s} H={h} causal={causal}", out, ref, dtype))
    b, s, h, _ = MAIN_SHAPES["vision"]
    for kv_len in (s, s * 3 // 4):  # every key, and keys >= kv_len masked (147 at S=197)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = flash_inputs((b, h, s, False, kv_len), dtype, dev, seed=3)
            out = ms.fused_mha_short(q, k, v, kv_len)
            ref = ms.mha_short_reference(q, k, v, kv_len)
            torch_sync()
            worst["fused_mha_short"] = max(worst["fused_mha_short"], _check_close(
                f"fused_mha_short B={b} H={h} S={s} kv_len={kv_len}", out, ref, dtype))
    return worst


def _composition_ms(inp, h, causal, with_ln: bool) -> float:
    """One chain of PyTorch calls that computes what a fused kernel computes
    (layer_norm + addmm for qkv when ``with_ln``, then
    scaled_dot_product_attention, addmm for the out-projection, and the
    residual add): no single call does it. The port never calls these."""
    import torch
    import torch.nn.functional as F

    x = inp["x"]
    b, s, d = x.shape
    dt = x.dtype
    g, beta = (t.to(dt) for t in inp["ln"])
    w_qkv, b_qkv, w_out, b_out = (t.to(dt) for t in inp["attn"])

    def heads(t):
        return t.reshape(b, s, h, d // h).transpose(1, 2)

    def run():
        if with_ln:
            qkv = torch.addmm(b_qkv, F.layer_norm(x, (d,), g, beta).reshape(b * s, d), w_qkv)
        else:
            qkv = inp["qkv"].reshape(b * s, 3 * d)
        q, k, v = (heads(t) for t in qkv.reshape(b, s, 3 * d).split(d, dim=-1))
        o = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        return x + torch.addmm(b_out, o.transpose(1, 2).reshape(b * s, d), w_out).reshape(b, s, d)

    return _time_ms(run)


def time_fused(ms, dev) -> dict:
    """The two fused kernels at the vision shape (bf16 and f32) and the text
    shape (bf16), the pre-split kernel at the vision shape (bf16): plain,
    kernel, kernel, plain; each bound from the same inputs (f32 products at
    the float32 peak, bf16 at the tensor cores')."""
    import torch

    times = {}
    cases = [("vision", torch.bfloat16), ("vision", torch.float32), ("text", torch.bfloat16)]
    for tower, dtype in cases:
        b, s, h, causal = MAIN_SHAPES[tower]
        d, dh = h * 64, 64
        inp = fused_inputs(b, s, h, dtype, dev, seed=4)
        size = 2 if dtype == torch.bfloat16 else 4
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        act = b * s * d * size  # one [B, S, D] activation
        attn_ops = attention_ops(b, h, s, dh, causal)
        proj_ops = 2 * b * s * d * d
        ops = {"fused_mha_packed_proj": attn_ops + proj_ops,
               "fused_attn_block": 2 * b * s * d * 3 * d + attn_ops + proj_ops}
        bounds = {  # inputs read once, the output written once
            "fused_mha_packed_proj": bound(3 * act + d * d * size + d * 4 + 2 * act,
                                           {kind: ops["fused_mha_packed_proj"]}),
            "fused_attn_block": bound(2 * act + 4 * d * d * size + 6 * d * 4,
                                      {kind: ops["fused_attn_block"]}),
        }
        for name, (kernel, plain) in _fused_calls(ms, inp, h, causal).items():
            p1, k1, k2, p2 = _time_ms(plain), _time_ms(kernel), _time_ms(kernel), _time_ms(plain)
            lib = _composition_ms(inp, h, causal, with_ln=name == "fused_attn_block")
            t = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib,
                 **bounds[name]}
            t["tflops"] = ops[name] / t["ms"] / 1e9
            t["bound_share"] = t["bound_ms"] / t["ms"]
            times[f"{name} {tower} {kind}"] = t
            print(f"  {name} {tower} B={b} S={s} H={h} causal={causal} {kind}: kernel "
                  f"{k1:.4f}/{k2:.4f} ms ({t['tflops']:.1f} TFLOP/s, "
                  f"{100 * t['bound_share']:.1f} % of the bound), plain {p1:.4f}/{p2:.4f} ms, "
                  f"library composition {lib:.4f} ms, bound {t['bound_ms']:.4f} ms "
                  f"({t['bound_by']})")
    b, s, h, _ = MAIN_SHAPES["vision"]
    q, k, v = flash_inputs((b, h, s, False, None), torch.bfloat16, dev, seed=5)
    kernel = lambda: ms.fused_mha_short(q, k, v)  # noqa: E731
    plain = lambda: ms.mha_short_reference(q, k, v)  # noqa: E731
    p1, k1, k2, p2 = _time_ms(plain), _time_ms(kernel), _time_ms(kernel), _time_ms(plain)
    lib = sdpa_ms(q, k, v, False)
    t = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib,
         **bound(4 * q.numel() * 2, {"bf16": attention_ops(b, h, s, 64, False)})}
    times["fused_mha_short vision bf16"] = t
    print(f"  fused_mha_short vision B={b} H={h} S={s} bf16: kernel {k1:.4f}/{k2:.4f} ms, plain "
          f"{p1:.4f}/{p2:.4f} ms, scaled_dot_product_attention {lib:.4f} ms, bound "
          f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    return times


# the CUDA-core bf16 kernels that the tensor-core ones replaced: their card ms
# as PERF.md §6 records them (this script's phase 4 on an NVIDIA H100 80GB HBM3
# at 700.00 W), by phase-4 key -> (kernel, ms, the attention's shape (B, H, S,
# causal))
CUDA_CORE_MS = {
    "vision": ("fused_mha_packed", 1.6571, (128, 12, 197, False)),
    "text": ("fused_mha_packed", 0.0456, (32, 8, 77, True)),
    "fused_mha_short vision bf16": ("fused_mha_short", 1.6671, (128, 12, 197, False)),
    "tp vision nm=2": ("fused_mha_packed_tp, one rank", 0.8636, (128, 6, 197, False)),
    "tp vision nm=4": ("fused_mha_packed_tp, one rank", 0.4564, (128, 3, 197, False)),
    "tp text nm=2": ("fused_mha_packed_tp, one rank", 0.0243, (32, 4, 77, True)),
    "flash vision": ("flash_attention", 1.9232, (128, 12, 197, False)),
    "flash text": ("flash_attention", 0.0480, (32, 8, 77, True)),
    "v2 f32exp": ("fused_mha_short_v2 f32exp", 1.6021, (128, 12, 197, False)),
    "v2 bf16exp": ("fused_mha_short_v2 bf16exp", 1.6062, (128, 12, 197, False)),
}


def report_redesign(times: dict, flash_times: dict) -> None:
    """The tensor-core attention kernels' phase-4 times beside the CUDA-core
    kernels' ms of PERF.md, SDPA (the factor) and the bound (its share)."""
    measured = {**times, **{f"flash {k}": t for k, t in flash_times.items()}}
    for key, (name, before, (b, h, s, causal)) in CUDA_CORE_MS.items():
        t = measured[key]
        tflops = attention_ops(b, h, s, 64, causal) / t["ms"] / 1e9
        now = f", {t['cuda_core_ms']:.4f} ms in this run" if "cuda_core_ms" in t else ""
        floor = f"; {100 * t['fma_floor_ms'] / t['ms']:.1f} % of its FMA floor" \
            if "fma_floor_ms" in t else ""
        print(f"  {name} ({key}): {t['ms']:.4f} ms on the tensor cores against the CUDA-core "
              f"kernel's {before:.4f} ms (PERF.md){now}, {before / t['ms']:.2f}x faster; "
              f"{t['ms'] / t['library_ms']:.2f}x scaled_dot_product_attention; "
              f"{100 * t['bound_ms'] / t['ms']:.1f} % of the bound{floor}; {tflops:.1f} TFLOP/s")


# the GEMMs that moved from mma.sync to wgmma + TMA: their mma.sync card ms as
# PERF.md §6 records them (this script's phase 4 on an NVIDIA H100 80GB HBM3 at
# 700.00 W), by phase-4 key -> (kernel, ms, int8 or bf16 operations of the
# call)
MMA_SYNC_MS = {
    "int8_linear_gelu_quant fc": ("int8_linear_gelu_quant (#21, bn 512)", 0.9412,
                                  2 * 128 * 197 * FC_SHAPE[0] * FC_SHAPE[1]),
    "probe_mm bf16": ("probe_mm bf16 (#27, M=N=K=4096)", 0.7349, 2 * 4096 ** 3),
    "probe_mm int8": ("probe_mm int8 (#27, M=N=K=4096)", 0.3744, 2 * 4096 ** 3),
    "int8_linear qkv": ("int8_linear (#15) qkv", 0.3669, 2 * 128 * 197 * 768 * 2304),
    "int8_linear out": ("int8_linear (#15) out", 0.1312, 2 * 128 * 197 * 768 * 768),
    "int8_linear_blockscale proj": ("int8_linear_blockscale (#20) proj, 6 K blocks", 0.4344,
                                    2 * 128 * 197 * PROJ_SHAPE[0] * PROJ_SHAPE[1]),
}


def report_gemm_redesign(times: dict) -> None:
    """The wgmma GEMMs' phase-4 times beside their mma.sync ms of PERF.md (and,
    for the int8 ones, the mma.sync kernel timed in this run), the library
    call, the bound (its share) and the rate."""
    for key, (name, before, ops) in MMA_SYNC_MS.items():
        t = times[key]
        now = f", the mma.sync kernel in this run {t['mma_sync_ms']:.4f} ms" \
            if "mma_sync_ms" in t else ""
        print(f"  {name}: {t['ms']:.4f} ms on wgmma + TMA against the mma.sync kernel's "
              f"{before:.4f} ms (PERF.md), {before / t['ms']:.2f}x faster{now}; "
              f"{t['ms'] / t['library_ms']:.2f}x the library call ({t['library_ms']:.4f} ms); "
              f"{100 * t['bound_ms'] / t['ms']:.1f} % of the bound; "
              f"{ops / t['ms'] / 1e9:.1f} T{'FLOP' if 'bf16' in key else 'OP'}/s")


# the int8 attention kernels that moved from the CUDA cores to mma.sync: their
# CUDA-core card ms as PERF.md §6 records them (this script's phase 4 on an
# NVIDIA H100 80GB HBM3 at 700.00 W), by phase-4 key -> (kernel, ms)
CUDA_CORE_INT8_MS = {
    "fused_mha_packed_q": ("fused_mha_packed_q (#5)", 1.5950),
    "fused_mha_packed_q3": ("fused_mha_packed_q3 (#6)", 1.6192),
    "q3i": ("fused_mha_packed_q3i (#7), static", 1.1098),
    "q3i[exp2i]": ("#7 exp2i", 1.1248),
    "q3i[reduce]": ("#7 reduce", 1.1341),
    "q3i[reduce_defer]": ("#7 reduce, deferred", 1.1189),
    "q3i[pv_int8]": ("#7 pv_int8", 0.9749),
    "q3i[pv_int8_defer]": ("#7 pv_int8, deferred", 0.9786),
    "q3i_sb": ("fused_mha_packed_q3i_sb (#10)", 1.1491),
    "q3i_tp vision nm=2": ("fused_mha_packed_q3i_tp (#11) nm 2, one rank", 0.5914),
    "q3i_tp vision nm=4": ("fused_mha_packed_q3i_tp (#11) nm 4, one rank", 0.3130),
    "variant full": ("#29 full", 1.1100),
    "variant noexp": ("#29 noexp", 1.0967),
    "variant qkonly": ("#29 qkonly", 0.2076),
    "variant nopv": ("#29 nopv", 0.2137),
}


def report_int8_attention_redesign(times: dict) -> None:
    """The int8 attention kernels' phase-4 times on the tensor cores beside
    their CUDA-core ms of PERF.md and the bound (its share)."""
    for key, (name, before) in CUDA_CORE_INT8_MS.items():
        t = times[key]
        print(f"  {name}: {t['ms']:.4f} ms on mma.sync against the CUDA-core kernel's "
              f"{before:.4f} ms (PERF.md), {before / t['ms']:.2f}x faster; bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"{100 * t['bound_ms'] / t['ms']:.1f} % of it")


# the kernels redesigned last: their earlier card ms as PERF.md §6 records
# them (this script's phase 4 on an NVIDIA H100 80GB HBM3 at 700.00 W), by
# phase-4 key -> (kernel, ms): #8/#9 with one computing warp a block, #30 and
# #28 on mma.sync
EARLIER_MS = {
    "q3i_cls": ("fused_mha_packed_q3i_cls (#8)", 0.0290),
    "q3i_cls_split": ("fused_mha_packed_q3i_cls_split (#9)", 0.0292),
    "mlp_mega": ("mlp_mega (#30), a pair at B=256", 3.1718),
    "mxu_ceiling int8": ("mxu_ceiling (#28) int8, M=512 K=N=768 REPS=2000", 1.1358),
    "mxu_ceiling bf16": ("mxu_ceiling (#28) bf16, M=512 K=N=768 REPS=2000", 2.5043),
}


def report_last_redesigns(times: dict) -> None:
    """#8, #9 and #30's phase-4 times beside their earlier ms of PERF.md and
    the bound (its share)."""
    for key, (name, before) in EARLIER_MS.items():
        t = times[key]
        print(f"  {name}: {t['ms']:.4f} ms against the earlier kernel's {before:.4f} ms "
              f"(PERF.md), {before / t['ms']:.2f}x faster; bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}), {100 * t['bound_ms'] / t['ms']:.1f} % of it")


def flash_inputs(shape, dtype, dev, seed=0, dh=64):
    """q, k and v ``[B, H, S, dh]`` for a shape whose first three are B, H, S."""
    import torch

    b, h, s = shape[:3]
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((b, h, s, dh), generator=g, device=dev).to(dtype) for _ in range(3)]


def _check_flash(label: str, out, ref, want_shape, dtype) -> float:
    import torch

    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[str(dtype)]
    print(f"  flash {label} {dtype}: max_abs_err={err:.3e} (tol {tol:g})")
    if tuple(out.shape) != tuple(want_shape) or not math.isfinite(err) or err > tol:
        raise AssertionError(f"flash kernel disagrees with its plain version: {err} > {tol}")
    return err


def compare_flash(fa, dev) -> float:
    """Every FLASH_SHAPES entry in each dtype compiled at its head width, then
    SigLIP's attention-pool query: one row of q, expanded over the batch
    (batch stride 0), against k and v of its 729 tokens."""
    import torch

    worst = 0.0
    for name, shape in FLASH_SHAPES.items():
        b, h, s, causal, kv_len, dh = shape
        for dtype in (torch.bfloat16, torch.float32):
            if dh not in fa._HEAD_DIMS[dtype]:
                continue
            q, k, v = flash_inputs(shape, dtype, dev, dh=dh)
            out = fa.flash_attention(q, k, v, kv_len, causal=causal)
            ref = fa.flash_attention_reference(q, k, v, kv_len, causal=causal)
            worst = max(worst, _check_flash(
                f"{name} B={b} H={h} S={s} dh={dh} causal={causal} kv_len={kv_len}", out, ref,
                q.shape, dtype))
    b, h, s, _, _, dh = FLASH_SHAPES["siglip"]
    _, k, v = flash_inputs(FLASH_SHAPES["siglip"], torch.bfloat16, dev, seed=2, dh=dh)
    g = torch.Generator(device=dev).manual_seed(4)
    probe = torch.randn((1, h, 1, dh), generator=g, device=dev).to(torch.bfloat16)
    q = probe.expand(b, h, 1, dh)
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_reference(q, k, v)
    return max(worst, _check_flash(f"pooling query B={b} H={h} Sq=1 S={s} dh={dh} (q batch "
                                   "stride 0)", out, ref, (b, h, 1, dh), torch.bfloat16))


def time_flash(fa, dev) -> dict:
    """The flash kernel at the towers' shapes in bf16 (PROOF's main path) and
    at SigLIP's blocks (the learners' encode on that backbone)."""
    import torch

    times = {}
    for name in ("vision", "text", "siglip"):
        b, h, s, causal, kv_len, dh = FLASH_SHAPES[name]
        q, k, v = flash_inputs(FLASH_SHAPES[name], torch.bfloat16, dev, seed=1, dh=dh)
        kernel = lambda: fa.flash_attention(q, k, v, kv_len, causal=causal)  # noqa: E731
        plain = lambda: fa.flash_attention_reference(q, k, v, kv_len, causal=causal)  # noqa: E731
        p1, k1, k2, p2 = _time_ms(plain), _time_ms(kernel), _time_ms(kernel), _time_ms(plain)
        lib = sdpa_ms(q, k, v, causal)
        times[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib,
                       **bound(4 * q.numel() * 2, {"bf16": attention_ops(b, h, s, dh, causal)})}
        t = times[name]
        print(f"  flash {name} B={b} H={h} S={s} dh={dh} causal={causal} bf16: kernel "
              f"{k1:.4f}/{k2:.4f} ms ({attention_ops(b, h, s, dh, causal) / t['ms'] / 1e9:.1f} "
              f"TFLOP/s, {100 * t['bound_ms'] / t['ms']:.1f} % of the bound), plain "
              f"{p1:.4f}/{p2:.4f} ms, scaled_dot_product_attention {lib:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    return times


def q3i_inputs(b, s, heads, dev, seed=0, dh=64):
    """int8 qkv and scales in the ranges of tests/test_torch_mha_q3i.py."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    d = heads * dh

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    qkv = torch.randint(-127, 128, (b, s, 3 * d), generator=g, device=dev, dtype=torch.int8)
    return (qkv, uniform((1, 3 * d), 0.01, 0.03), uniform((1, heads), 1e-4, 3e-4) * 4 / dh ** 0.5,
            uniform((1, d), 20, 60), uniform((1, heads), 3, 6))


def _int8_disagreement(name: str, out, ref, limit: int = 1,
                       max_frac: float = INT8_MAX_FRAC) -> int:
    diff = (out.int() - ref.int()).abs()
    worst, frac = int(diff.max().item()), (diff > 0).float().mean().item()
    print(f"  {name}: max |diff| {worst} int8 steps, {100 * frac:.5f} % of outputs differ "
          f"(limits {limit}, {100 * max_frac:g} %)")
    if out.shape != ref.shape or worst > limit or frac >= max_frac:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return worst


def pv_int8_limit(deq, oinv) -> int:
    """The int8 PV's limit in int8 steps: one, plus what one p8 = rint(p*127)
    on the other side of a rounding edge (p's sum taken in another order)
    moves an output by: |v8| * deq_v * o_inv / 127 <= deq_v * o_inv."""
    d = oinv.numel()
    return 1 + math.ceil((deq.reshape(-1)[2 * d:] * oinv.reshape(-1)).max().item())


def compare_q3i(ms, dev) -> dict:
    """Both integer-QK^T kernels against their plain versions; the CLS kernel
    also against row 0 of the full kernel."""
    worst = {"q3i": 0, "q3i_cls": 0}
    cases = [(*MAIN_SHAPES["vision"], None, True), (*MAIN_SHAPES["vision"], None, False),
             (*MAIN_SHAPES["text"], None, False), (32, 197, 12, False, 150, False),
             (32, 77, 8, True, 60, False)]
    for b, s, h, causal, kv_len, static in cases:
        qkv, deq, qks, oinv, m2 = q3i_inputs(b, s, h, dev)
        m2 = m2 if static else None
        out = ms.fused_mha_packed_q3i(qkv, deq, qks, oinv, h, causal=causal, kv_len=kv_len, qk_m2=m2)
        ref = ms.mha_packed_q3i_reference(qkv, deq, qks, oinv, h, causal, kv_len, m2)
        torch_sync()
        name = f"q3i B={b} S={s} H={h} causal={causal} kv_len={kv_len} static={static}"
        worst["q3i"] = max(worst["q3i"], _int8_disagreement(name, out, ref))
    b, s, h, _ = MAIN_SHAPES["vision"]
    for static in (True, False):
        qkv, deq, qks, oinv, m2 = q3i_inputs(b, s, h, dev, seed=1)
        m2 = m2 if static else None
        out = ms.fused_mha_packed_q3i_cls(qkv, deq, qks, oinv, h, qk_m2=m2)
        ref = ms.mha_packed_q3i_reference(qkv, deq, qks, oinv, h, qk_m2=m2, rows=1)
        full = ms.fused_mha_packed_q3i(qkv, deq, qks, oinv, h, qk_m2=m2)[:, :1].contiguous()
        torch_sync()
        name = f"q3i_cls B={b} S={s} H={h} static={static}"
        worst["q3i_cls"] = max(worst["q3i_cls"], _int8_disagreement(name + " vs plain", out, ref),
                               _int8_disagreement(name + " vs full kernel row 0", out, full))
    return worst


def compare_q3i_modes(ms, dev) -> dict:
    """The q3i kernel's other modes (Q3I_MODES) against the wrapper's plain
    version under the same knobs: the vision shape with the static constant
    given, and the masked shapes (causal text, kv_len), where exp2i and the
    static form fall to the f32 row max. The int8 PV is held to one step
    plus what one p8 flipped at a rounding edge moves an output by."""
    worst = dict.fromkeys(Q3I_MODES, 0)
    cases = [(*MAIN_SHAPES["vision"], None), (*MAIN_SHAPES["text"], None),
             (32, 197, 12, False, 150)]
    for mode, (env, kw) in Q3I_MODES.items():
        for b, s, h, causal, kv_len in cases:
            qkv, deq, qks, oinv, m2 = q3i_inputs(b, s, h, dev, seed=5)
            args = (qkv, deq, qks, oinv, h)
            call = dict(causal=causal, kv_len=kv_len, qk_m2=m2, **kw)
            with knobs(env):
                out = ms.fused_mha_packed_q3i(*args, **call)
                ref = ms.mha_packed_q3i_plain(*args, **call)
            torch_sync()
            limit = pv_int8_limit(deq, oinv) if kw.get("pv_int8") else 1
            worst[mode] = max(worst[mode], _int8_disagreement(
                f"q3i[{mode}] B={b} S={s} H={h} causal={causal} kv_len={kv_len}", out, ref, limit))
    return worst


def compare_q3i_split_sb(ms, dev) -> dict:
    """The split CLS kernel against the CLS kernel on the packed tensor that
    its q and kv make (tolerance 0: bit for bit) and against its plain
    version; the sequence-major kernel against its plain version and, bit for
    bit, against the packed entry on the transposed rows with its arithmetic
    (f32 row max, reduce)."""
    import torch

    worst = {"q3i_cls_split": 0, "q3i_sb": 0}
    b, s, h, _ = MAIN_SHAPES["vision"]
    d = h * 64
    for static in (True, False):
        qkv, deq, qks, oinv, m2 = q3i_inputs(b, s, h, dev, seed=6)
        m2 = m2 if static else None
        q, kv = qkv[:, :1, :d].contiguous(), qkv[:, :, d:].contiguous()
        out = ms.fused_mha_packed_q3i_cls_split(q, kv, deq, qks, oinv, h, qk_m2=m2)
        packed = ms.fused_mha_packed_q3i_cls(qkv, deq, qks, oinv, h, qk_m2=m2)
        ref = ms.mha_packed_q3i_cls_split_plain(q, kv, deq, qks, oinv, h, qk_m2=m2)
        torch_sync()
        name = f"q3i_cls_split B={b} S={s} H={h} static={static}"
        equal = torch.equal(out, packed)
        print(f"  {name} vs q3i_cls on the packed tensor: bit for bit {equal} (tolerance 0)")
        if not equal:
            raise AssertionError("q3i_cls_split differs from q3i_cls on the same q, k and v")
        worst["q3i_cls_split"] = max(worst["q3i_cls_split"],
                                     _int8_disagreement(name + " vs plain", out, ref))
    qkv, deq, qks, oinv, _ = q3i_inputs(s, b, h, dev, seed=7)  # [S, B, 3D]
    out = ms.fused_mha_packed_q3i_sb(qkv, deq, qks, oinv, h)
    ref = ms.mha_packed_q3i_sb_reference(qkv, deq, qks, oinv, h)
    with knobs({"TEAM_QI_SOFTMAX": "f32", "TEAM_QI_ROWSUM": "reduce"}):
        packed = ms.fused_mha_packed_q3i(qkv.transpose(0, 1).contiguous(), deq, qks, oinv, h)
    torch_sync()
    name = f"q3i_sb S={s} B={b} H={h}"
    equal = torch.equal(out, packed.transpose(0, 1))
    print(f"  {name} vs q3i (f32, reduce) on the transposed rows: bit for bit {equal} (tolerance 0)")
    if not equal:
        raise AssertionError("q3i_sb differs from the packed entry with the same arithmetic")
    worst["q3i_sb"] = _int8_disagreement(name + " vs plain", out, ref)
    return worst


def time_q3i(ms, dev) -> dict:
    """The integer-QK^T kernels at the vision shape: the full and CLS kernels
    with the static softmax (the main path's form), the full kernel's other
    modes (under their knobs), the split CLS kernel and the sequence-major one."""
    b, s, h, _ = MAIN_SHAPES["vision"]
    d, dh = h * 64, 64
    qkv, deq, qks, oinv, m2 = q3i_inputs(b, s, h, dev, seed=2)
    q, kv = qkv[:, :1, :d].contiguous(), qkv[:, :, d:].contiguous()
    qkv_sb = qkv.transpose(0, 1).contiguous()
    args = (qkv, deq, qks, oinv, h)
    pairs = {  # name: (knobs, kernel, plain)
        "q3i": ({}, lambda: ms.fused_mha_packed_q3i(*args, qk_m2=m2),
                lambda: ms.mha_packed_q3i_reference(*args, qk_m2=m2)),
        "q3i_cls": ({}, lambda: ms.fused_mha_packed_q3i_cls(*args, qk_m2=m2),
                    lambda: ms.mha_packed_q3i_reference(*args, qk_m2=m2, rows=1)),
        **{f"q3i[{mode}]": (env, lambda kw=kw: ms.fused_mha_packed_q3i(*args, qk_m2=m2, **kw),
                            lambda kw=kw: ms.mha_packed_q3i_plain(*args, qk_m2=m2, **kw))
           for mode, (env, kw) in Q3I_MODES.items()},
        "q3i_cls_split": ({}, lambda: ms.fused_mha_packed_q3i_cls_split(q, kv, *args[1:], qk_m2=m2),
                          lambda: ms.mha_packed_q3i_cls_split_plain(q, kv, *args[1:], qk_m2=m2)),
        "q3i_sb": ({}, lambda: ms.fused_mha_packed_q3i_sb(qkv_sb, *args[1:]),
                   lambda: ms.mha_packed_q3i_sb_reference(qkv_sb, *args[1:])),
    }
    vec_bytes = sum(t.numel() * 4 for t in (deq, qks, oinv, m2))
    # what each function needs: all of qkv and its [B, S, D] output; the CLS
    # forms read q's row 0 and all of k and v, and write one row
    full = bound(qkv.numel() + b * s * d + vec_bytes,
                 {"int8": attention_ops(b, h, s, dh, False) // 2,
                  "bf16": attention_ops(b, h, s, dh, False) // 2})
    cls = bound(b * d + 2 * b * s * d + b * d + vec_bytes,
                {"int8": attention_ops(b, h, s, dh, False, rows=1) // 2,
                 "bf16": attention_ops(b, h, s, dh, False, rows=1) // 2})
    times = {}
    for name, (env, kernel, plain) in pairs.items():
        bnd = cls if "cls" in name else full
        with knobs(env):
            p1, k1, k2, p2 = _time_ms(plain), _time_ms(kernel), _time_ms(kernel), _time_ms(plain)
        times[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": None, **bnd}
        print(f"  {name} B={b} S={s} H={h} int8: kernel {k1:.4f}/{k2:.4f} ms, "
              f"plain {p1:.4f}/{p2:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}); no single PyTorch call computes it")
    return times


def compare_int8_io(ms, im, dev) -> dict:
    """The int8-I/O attention kernels (f32 and bf16 dequant), the two
    quantize producers and the static tower's epilogues
    (compare_static_epilogues) against their plain versions."""
    import torch

    worst = dict.fromkeys(("fused_mha_packed_q", "fused_mha_packed_q3", "ln_quantize_static",
                           "row_quant_static"), 0)
    cases = [(*MAIN_SHAPES["vision"], None), (32, 197, 12, False, 150), (32, 77, 8, True, 60)]
    for b, s, h, causal, kv_len in cases:
        qkv, deq, oinv = packed_q_inputs(b, s, h, dev)
        for name, bf16_deq in (("fused_mha_packed_q", False), ("fused_mha_packed_q3", True)):
            if bf16_deq:
                out = ms.fused_mha_packed_q3(qkv, deq, oinv, h, causal=causal, kv_len=kv_len)
            else:
                out = ms.fused_mha_packed_q(qkv.reshape(b * s, -1), deq, oinv, h, seq=s,
                                            causal=causal, kv_len=kv_len).reshape(b, s, -1)
            ref = ms.mha_packed_q_reference(qkv, deq, oinv, h, causal, kv_len, bf16_deq)
            torch_sync()
            worst[name] = max(worst[name], _int8_disagreement(
                f"{name} B={b} S={s} H={h} causal={causal} kv_len={kv_len}", out, ref))
    b, s, _, _ = MAIN_SHAPES["vision"]
    for m in (b * s, FLAGSHIP_BATCH * s + 5):  # the eval batch's rows, and a ragged edge
        x, gamma, beta, inv_a = producer_inputs(m, 768, dev)
        out = im.ln_quantize_static(x, gamma, beta, inv_a)
        ref = im.ln_quantize_static_reference(x, gamma, beta, inv_a)
        row, row_ref = im.row_quant_static(x, inv_a), im.row_quant_static_reference(x, inv_a)
        torch_sync()
        worst["ln_quantize_static"] = max(worst["ln_quantize_static"], _int8_disagreement(
            f"ln_quantize_static M={m} D=768", out, ref))
        diff = int((row.int() - row_ref.int()).abs().max().item())
        print(f"  row_quant_static M={m} D=768: max |diff| {diff} int8 steps (limit 0: bit-equal)")
        if row.shape != row_ref.shape or diff != 0:
            raise AssertionError("row_quant_static: kernel differs from its plain version")
    worst.update(compare_static_epilogues(im, dev))
    return worst


# the static tower's epilogues' sites: (name, rows, N) at the vision batch
# (qkv, fc, out/proj), the last block's CLS rows, and the gate batch's rows
# plus five, no multiple of any tile
EPILOGUE_SITES = [("qkv", 128 * 197, 2304), ("fc", 128 * 197, 3072), ("out", 128 * 197, 768),
                  ("cls", 128, 768), ("ragged", RAGGED_M + 5, 2304)]
# the bf16 towers' elementwise sites (csrc/tower_bf16.cu): rows at the towers'
# batches, width, MLP width, layer-norm eps, the fc site's GELU
TOWER_BF16_SITES = {"vitb16": (128 * 197, 768, 3072, 1e-5, "none"),
                    "siglip": (128 * 729, 1152, 4304, 1e-6, "tanh"),
                    "text": (32 * 77, 512, 2048, 1e-5, "none")}
# bias_act, residual_ln and layer_norm launches of one B=128 bf16 encode: a
# bias a GEMM (SigLIP's head: q, k/v, out, fc), a residual a half (and the
# head's MLP), layer norms ln_pre or ln_post, the first LN1 and the head's
TOWER_BF16_LAUNCHES = {"vitb16": (24, 24, 3), "siglip": (58, 55, 3)}
LN_MAX_FRAC = 0.001  # the layer norms: one bf16 step on under 0.1 % of their outputs,
# a step of outputs under LN_FLOOR counted at LN_FLOOR's (beta cancels there)
LN_FLOOR = 2.0 ** -10
# the towers through these kernels against the composition's: the layer norms'
# one-step differences compound over the blocks to 1 - cosine of 3.2e-5 -
# 3.5e-5 on ViT-B/16, as far as the composition lies from itself with its layer
# norm's sums in another order (3.3e-5 - 3.7e-5; three seeds, NVIDIA H100 80GB HBM3)
TOWER_COS = 0.9999


def compare_static_epilogues(im, dev) -> dict:
    """The static tower's epilogues and layer norm to int8 against their
    plain versions (the compositions they replace) at the tower's sites:
    ``static_requant`` without an activation and ``static_residual`` (a
    random bf16 residual, also the CLS form's row-strided ``x[:, :1]``) bit
    for bit; ``static_requant`` with either GELU and ``ln_quant_folded`` in
    either mode at most one int8 step on under EPILOGUE_MAX_FRAC of the
    outputs."""
    import torch

    worst = dict.fromkeys(("static_requant", "static_residual", "ln_quant_folded"), 0)
    for site, m, n in EPILOGUE_SITES:
        acc, scale, bias, a_inv = epilogue_inputs(m, n, dev, seed=m + n)
        for gelu in (None, "tanh", "sigmoid"):
            out = im.static_requant(acc, scale, bias, a_inv, gelu)
            ref = im.static_requant_reference(acc, scale, bias, a_inv, gelu)
            torch_sync()
            worst["static_requant"] = max(worst["static_requant"], _int8_disagreement(
                f"static_requant ({site}) M={m} N={n} activation={gelu}", out, ref,
                limit=0 if gelu is None else 1, max_frac=EPILOGUE_MAX_FRAC))
        g = torch.Generator(device=dev).manual_seed(n)
        cases = [("", torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16))]
        if site == "cls":  # the CLS rows' residual: x[:, :1] of the [B, S, D] stream
            stream = torch.randn((m, 197, n), generator=g, device=dev).to(torch.bfloat16)
            cases.append((", residual x[:, :1]", stream[:, :1]))
        for label, x in cases:
            acc3 = acc.reshape(x.shape)
            out = im.static_residual(acc3, scale, bias, x)
            ref = im.static_residual_reference(acc3, scale, bias, x)
            torch_sync()
            differ = int((out.view(torch.int16) != ref.view(torch.int16)).sum().item())
            print(f"  static_residual ({site}{label}) M={m} N={n}: {differ} of {ref.numel()} "
                  "bf16 outputs differ (limit 0: bit-equal)")
            if out.shape != ref.shape or out.dtype != ref.dtype or differ:
                raise AssertionError("static_residual: kernel differs from its plain version")
    for site, m in (("vision", 128 * 197), ("cls", 128), ("ragged", RAGGED_M + 5)):
        x, gamma, beta, a_inv = producer_inputs(m, 768, dev, seed=m)
        for two_pass in (False, True):
            out = im.ln_quant_folded(x, gamma, beta, a_inv, two_pass=two_pass)
            ref = im.ln_quant_folded_reference(x, gamma, beta, a_inv, two_pass)
            torch_sync()
            worst["ln_quant_folded"] = max(worst["ln_quant_folded"], _int8_disagreement(
                f"ln_quant_folded ({site}, {'two' if two_pass else 'one'} pass) M={m} D=768",
                out, ref, max_frac=EPILOGUE_MAX_FRAC))
    return worst


def tower_inputs(rows, d, dev, seed=0):
    """A bf16 residual stream with a spread per row, a GEMM output, a bf16
    bias and a layer norm's float32 affine."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((rows, d), generator=g, device=dev)
         * (torch.rand((rows, 1), generator=g, device=dev) * 3 + 0.5)).to(torch.bfloat16)
    y = torch.randn((rows, d), generator=g, device=dev).to(torch.bfloat16)
    b = (torch.randn(d, generator=g, device=dev) * 0.1).to(torch.bfloat16)
    return (x, y, b, torch.rand(d, generator=g, device=dev) + 0.5,
            torch.rand(d, generator=g, device=dev) * 0.4 - 0.2)


def _bf16_disagreement(name: str, out, ref, max_frac: float) -> float:
    """The share of bf16 outputs that differ from the plain version's: none
    where ``max_frac`` is 0; else at most one bf16 step of the output's
    magnitude, floored at LN_FLOOR, on under ``max_frac`` of the outputs."""
    import torch

    differ = out.view(torch.int16) != ref.view(torch.int16)
    frac = differ.float().mean().item()
    w = ref.float()
    step = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=LN_FLOOR))) - 7)
    worst = ((out.float() - w).abs() / step).max().item()
    limits = "bit-equal required" if max_frac == 0 else f"limits 1, {100 * max_frac:g} %"
    print(f"  {name}: {int(differ.sum().item())} of {ref.numel()} bf16 outputs differ, by at "
          f"most {worst:g} step ({limits})")
    if out.shape != ref.shape or out.dtype != ref.dtype or (
            frac > 0 if max_frac == 0 else (worst > 1 or frac >= max_frac)):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return frac


def compare_tower_bf16(tb, dev) -> dict:
    """The bf16 towers' elementwise kernels against the compositions they
    replace, at ViT-B/16's, SigLIP's and the text tower's sites: bias_act at
    the qkv bias and the fc bias with the tower's GELU, residual_ln with and
    without its layer norm, layer_norm, all bit for bit but the layer norms
    (one bf16 step on under LN_MAX_FRAC); layer_norm also on ViT-B/16's CLS
    rows x[:, 0] (rows 197 * 768 apart) and the attention-pool head's 128 rows."""
    import torch

    worst = {"bias_act": 0.0, "residual_ln": 0.0, "layer_norm": 0.0}
    for tower, (m, d, f, eps, gelu) in TOWER_BF16_SITES.items():
        for n, act in ((3 * d, None), (f, gelu)):
            _, y, _, _, _ = tower_inputs(m, n, dev, seed=n)
            b = tower_inputs(1, n, dev, seed=n + 1)[2]
            ref = tb.bias_act_reference(y, b, act)
            out = tb.bias_act(y, b, act)
            torch_sync()
            _bf16_disagreement(f"bias_act ({tower}, gelu {act}) M={m} N={n}", out, ref, 0)
        x, y, b, gamma, beta = tower_inputs(m, d, dev, seed=d)
        ref, ref_h = tb.residual_ln_reference(x, y.clone(), b, gamma, beta, eps)
        out, h = tb.residual_ln(x, y.clone(), b, gamma, beta, eps)
        plain_out, _ = tb.residual_ln(x, y, b)
        torch_sync()
        _bf16_disagreement(f"residual_ln ({tower}) x' M={m} D={d}", out, ref, 0)
        _bf16_disagreement(f"residual_ln ({tower}, no LN) x' M={m} D={d}", plain_out, ref, 0)
        worst["residual_ln"] = max(worst["residual_ln"], _bf16_disagreement(
            f"residual_ln ({tower}) LN eps {eps:g} M={m} D={d}", h, ref_h, LN_MAX_FRAC))
        cases = [(tower, x, eps)]
        if tower == "vitb16":
            cases.append(("vitb16 CLS rows", x.reshape(128, 197, d)[:, 0], eps))
        if tower == "siglip":
            cases.append(("siglip pool head", x[:128], eps))
        for label, xs, e in cases:
            out = tb.layer_norm(xs, gamma, beta, e)
            ref = tb.layer_norm_reference(xs, gamma, beta, e)
            torch_sync()
            worst["layer_norm"] = max(worst["layer_norm"], _bf16_disagreement(
                f"layer_norm ({label}) {tuple(xs.shape)}", out, ref, LN_MAX_FRAC))
    return worst


def time_tower_bf16(tb, dev) -> dict:
    """The bf16 towers' elementwise kernels at ViT-B/16's and SigLIP's B=128
    sites against their compositions and their bounds: every byte in and out
    once at 3.35 TB/s (bias_act 2 * M * N * 2 bytes; residual_ln with its
    layer norm x and y in, x' and h out; layer_norm M * D in and out).
    layer_norm is also timed against the library's one call, ``F.layer_norm``,
    as a yardstick of speed: on CUDA it refuses a float32 affine with a bf16
    input (the towers' form), so it runs with gamma and beta rounded to bf16,
    a coarser function that cannot stand in for the kernel. No single PyTorch
    call computes a bias with the GELU or a residual with the next layer
    norm."""
    from functools import partial

    import torch.nn.functional as F

    times = {}
    for tower in ("vitb16", "siglip"):
        m, d, f, eps, gelu = TOWER_BF16_SITES[tower]
        x, y, b, gamma, beta = tower_inputs(m, d, dev, seed=7)
        _, yf, _, _, _ = tower_inputs(m, f, dev, seed=8)
        bf = tower_inputs(1, f, dev, seed=9)[2]
        vec = 2 * d * 4 + d * 2
        pairs = {
            f"bias_act {tower} fc": (partial(tb.bias_act, yf, bf, gelu),
                                     partial(tb.bias_act_reference, yf, bf, gelu), None,
                                     bound(2 * yf.numel() * 2 + f * 2, {})),
            f"residual_ln {tower}": (partial(tb.residual_ln, x, y, b, gamma, beta, eps),
                                     partial(tb.residual_ln_reference, x, y, b, gamma, beta, eps),
                                     None, bound(4 * x.numel() * 2 + vec, {})),
            f"layer_norm {tower}": (partial(tb.layer_norm, x, gamma, beta, eps),
                                    partial(tb.layer_norm_reference, x, gamma, beta, eps),
                                    partial(F.layer_norm, x, (d,), gamma.to(x.dtype),
                                            beta.to(x.dtype), eps),
                                    bound(2 * x.numel() * 2 + 2 * d * 4, {})),
        }
        for name, (kernel, plain, library, bnd) in pairs.items():
            p1, k1 = _time_ms(plain), _time_ms(kernel)
            lib = [_time_ms(library), _time_ms(library)] if library else []
            k2, p2 = _time_ms(kernel), _time_ms(plain)
            lib_ms = sum(lib) / 2 if lib else None
            times[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib_ms,
                           **bnd}
            lib_txt = f", library {lib[0]:.4f}/{lib[1]:.4f} ms" if lib else ""
            print(f"  {name} (M={m}): kernel {k1:.4f}/{k2:.4f} ms, composition {p1:.4f}/{p2:.4f} "
                  f"ms{lib_txt}, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
                  f"{100 * bnd['bound_ms'] / ((k1 + k2) / 2):.1f} % of it")
        del x, y, yf
    return times


def packed_q_inputs(b, s, heads, dev, seed=0, dh=64):
    """int8 qkv and per-channel scales in the ranges of tests/test_torch_int8_static.py."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    d = heads * dh
    qkv = torch.randint(-127, 128, (b, s, 3 * d), generator=g, device=dev, dtype=torch.int8)
    deq = torch.rand((1, 3 * d), generator=g, device=dev) * 0.02 + 0.01
    return qkv, deq, torch.rand((1, d), generator=g, device=dev) * 40 + 20


def epilogue_inputs(m, n, dev, seed=0):
    """int32 sums of a K=768 product [M, N] and a static site's scale, bias
    and inv_a in a calibrated tower's ranges."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    acc = torch.randint(-400_000, 400_000, (m, n), generator=g, device=dev, dtype=torch.int32)
    return (acc, torch.rand((1, n), generator=g, device=dev) * 2e-5 + 1e-6,
            torch.randn(n, generator=g, device=dev) * 0.1,
            torch.rand((1, n), generator=g, device=dev) * 40 + 10)


def producer_inputs(m, d, dev, seed=0):
    """bf16 activations with a spread per row, a layer norm's affine, inv_a."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((m, d), generator=g, device=dev)
         * (torch.rand((m, 1), generator=g, device=dev) * 3.5 + 0.5)).to(torch.bfloat16)
    return (x, torch.rand(d, generator=g, device=dev) + 0.5,
            torch.rand(d, generator=g, device=dev) * 0.4 - 0.2,
            torch.rand((1, d), generator=g, device=dev) * 50 + 10)


def time_int8_io(ms, im, dev) -> dict:
    """The int8-I/O attention kernels, the static producers and the static
    tower's epilogues at the vision shape (B=128, S=197, D=768; the
    epilogues at the qkv, fc and out widths), with each function's bound from
    its bytes and operations. No single PyTorch call computes any of them
    (``torch.quantize_per_channel``, the nearest to ``row_quant_static``,
    divides by the scale, clips to [-128, 127] and takes no bf16)."""
    from functools import partial

    import torch

    b, s, h, _ = MAIN_SHAPES["vision"]
    d, dh = h * 64, 64
    qkv, deq, oinv = packed_q_inputs(b, s, h, dev, seed=3)
    qkv2 = qkv.reshape(b * s, 3 * d)
    x, gamma, beta, inv_a = producer_inputs(b * s, d, dev, seed=1)
    attn_bound = bound(qkv.numel() + b * s * d + (deq.numel() + oinv.numel()) * 4,
                       {"bf16": attention_ops(b, h, s, dh, False)})
    producer_bytes = x.numel() * 2 + x.numel()
    pairs = {
        "fused_mha_packed_q": (lambda: ms.fused_mha_packed_q(qkv2, deq, oinv, h, seq=s),
                               lambda: ms.mha_packed_q_reference(qkv, deq, oinv, h), attn_bound),
        "fused_mha_packed_q3": (lambda: ms.fused_mha_packed_q3(qkv, deq, oinv, h),
                                lambda: ms.mha_packed_q_reference(qkv, deq, oinv, h, bf16_deq=True),
                                attn_bound),
        "ln_quantize_static": (lambda: im.ln_quantize_static(x, gamma, beta, inv_a),
                               lambda: im.ln_quantize_static_reference(x, gamma, beta, inv_a),
                               bound(producer_bytes + 3 * d * 4, {})),
        "row_quant_static": (lambda: im.row_quant_static(x, inv_a),
                             lambda: im.row_quant_static_reference(x, inv_a),
                             bound(producer_bytes + d * 4, {})),
        "ln_quant_folded": (lambda: im.ln_quant_folded(x, gamma, beta, inv_a),
                            lambda: im.ln_quant_folded_reference(x, gamma, beta, inv_a),
                            bound(producer_bytes + 3 * d * 4, {})),
    }
    # the static tower's epilogues at its qkv, fc and out sites: int32 sums in
    for name, n, gelu, to in (("static_requant", 3 * d, None, "qkv"),
                              ("static_requant_gelu", 4 * d, "tanh", "fc"),
                              ("static_residual", d, None, "out")):
        acc, scale, bias, a_inv = epilogue_inputs(b * s, n, dev)
        if name == "static_residual":
            res = torch.randn(acc.shape, device=dev).to(torch.bfloat16)
            pairs[f"{name} ({to})"] = (
                partial(im.static_residual, acc, scale, bias, res),
                partial(im.static_residual_reference, acc, scale, bias, res),
                bound(acc.numel() * (4 + 2 + 2) + 2 * n * 4, {}))
        else:
            pairs[f"{name} ({to})"] = (
                partial(im.static_requant, acc, scale, bias, a_inv, gelu),
                partial(im.static_requant_reference, acc, scale, bias, a_inv, gelu),
                bound(acc.numel() * (4 + 1) + 3 * n * 4, {}))
    times = {}
    for name, (kernel, plain, bnd) in pairs.items():
        p1, k1, k2, p2 = _time_ms(plain), _time_ms(kernel), _time_ms(kernel), _time_ms(plain)
        times[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": None, **bnd}
        print(f"  {name} (vision shape, M={b * s}): kernel {k1:.4f}/{k2:.4f} ms, plain "
              f"{p1:.4f}/{p2:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); "
              "no single PyTorch call computes it")
    return times


def gemm_inputs(im, m, k, n, dev, seed=0):
    """Row-quantized activations, a quantized [K, N] weight (column-major, as
    a payload holds it), its scales and a bias."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    xq, xs = im.quantize_rows(torch.randn((m, k), generator=g, device=dev))
    wq, ws = im.quantize_weight(torch.randn((k, n), generator=g, device=dev) * k ** -0.5)
    return xq, wq, xs, ws, torch.randn(n, generator=g, device=dev) * 0.1


def _check_gemm(name: str, out, ref) -> float:
    """max |out - ref|; raises past one bf16 step (2^-7 |ref|) for bf16, and
    past 1e-5 of the largest |ref| (tanh from another library; without the
    GELU the same products in the same order) for both."""
    import torch

    err = (out.float() - ref.float()).abs()
    limit = 1e-5 * ref.float().abs().max().item()
    if out.dtype == torch.bfloat16:
        limit = limit + BF16_STEP * ref.float().abs()
    worst = err.max().item()
    print(f"  {name}: max_abs_err={worst:.3e} (limit 1e-5 max|ref|"
          f"{' + 2^-7 |ref|' if out.dtype == torch.bfloat16 else ''})")
    if out.shape != ref.shape or out.dtype != ref.dtype or not bool((err <= limit).all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return worst


def _check_scales(name: str, s, ref) -> float:
    rel = ((s - ref).abs() / ref.abs()).max().item()
    print(f"  {name} scales: max relative difference {rel:.3e} (limit 1e-6)")
    if s.shape != ref.shape or not rel <= 1e-6:
        raise AssertionError(f"{name}: scales disagree with the plain version")
    return rel


def _check_wgmma_equal(name: str, out, mma) -> None:
    """The wgmma kernel's output against its mma.sync kernel's, bit for bit."""
    import torch

    equal = torch.equal(out, mma)
    print(f"  {name}: the wgmma kernel vs the mma.sync kernel, bit for bit {equal} (tolerance 0)")
    if not equal:
        raise AssertionError(f"{name}: the wgmma kernel differs from the mma.sync kernel "
                             f"({(out != mma).sum().item()} outputs)")


def compare_int8_gemm(im, dev) -> dict:
    """The int8 GEMM kernels and the dynamic layer norm -> int8 kernel against
    their plain versions at the vision tower's shapes and at the gate batch's
    ragged M: int8_linear at qkv and out (bf16 and f32, with and without the
    GELU; the [N, K] entry bit for bit the [K, N] one), gelu_quant at fc (bn
    512), blockscale at proj on its output (6 K blocks), each wgmma kernel
    also bit for bit its mma.sync one; ln_quantize; and ln_quantize_static3
    bit for bit ln_quantize_static."""
    import torch

    worst = dict.fromkeys(("int8_linear", "int8_linear_gelu_quant", "int8_linear_blockscale",
                           "ln_quantize"), 0.0)
    b, s, _, _ = MAIN_SHAPES["vision"]
    for m in (b * s, RAGGED_M):
        for shape, (k, n) in GEMM_SHAPES.items():
            xq, wq, xs, ws, bias = gemm_inputs(im, m, k, n, dev)
            for activation in (None, "gelu"):
                for dt in (torch.bfloat16, torch.float32):
                    kw = dict(activation=activation, out_dtype=dt)
                    out = im.int8_linear(xq, wq, xs, ws, bias, **kw)
                    ref = im.int8_linear_reference(xq, wq, xs, ws, bias, **kw)
                    mma = im.int8_linear_mma(xq, wq, xs, ws, bias, **kw)
                    torch_sync()
                    name = f"int8_linear {shape} M={m} K={k} N={n} {activation} {dt}"
                    worst["int8_linear"] = max(worst["int8_linear"], _check_gemm(name, out, ref))
                    _check_wgmma_equal(name, out, mma)
            nk = im.int8_linear_nk(xq, wq.t(), xs, ws, bias)
            equal = torch.equal(nk, im.int8_linear(xq, wq, xs, ws, bias))
            print(f"  int8_linear_nk {shape} M={m} vs int8_linear: bit for bit {equal} (tolerance 0)")
            if not equal:
                raise AssertionError("int8_linear_nk differs from int8_linear on the same weight")
        xq, wq, xs, ws, bias = gemm_inputs(im, m, *FC_SHAPE, dev, seed=1)
        gq, gs = im.int8_linear_gelu_quant(xq, wq, xs, ws, bias)
        rq, rs = im.int8_linear_gelu_quant_reference(xq, wq, xs, ws, bias)
        torch_sync()
        name = f"int8_linear_gelu_quant fc M={m} K={FC_SHAPE[0]} N={FC_SHAPE[1]} bn=512"
        if gs.shape != (FC_SHAPE[1] // 512, m):
            raise AssertionError(f"{name}: scales of shape {tuple(gs.shape)}")
        worst["int8_linear_gelu_quant"] = max(worst["int8_linear_gelu_quant"],
                                              _int8_disagreement(name, gq, rq))
        _check_scales(name, gs, rs)
        mq, ms_ = im.int8_linear_gelu_quant_mma(xq, wq, xs, ws, bias)
        torch_sync()
        equal = torch.equal(gq, mq) and torch.equal(gs, ms_)
        print(f"  {name}: the wgmma kernel vs the mma.sync kernel, q and s bit for bit {equal} "
              "(tolerance 0)")
        if not equal:
            raise AssertionError(f"{name}: the wgmma kernel differs from the mma.sync kernel")
        _, w2q, _, w2s, b2 = gemm_inputs(im, m, *PROJ_SHAPE, dev, seed=2)
        for dt in (torch.bfloat16, torch.float32):
            out = im.int8_linear_blockscale(gq, w2q, gs, w2s, b2, out_dtype=dt)
            ref = im.int8_linear_blockscale_reference(gq, w2q, gs, w2s, b2, out_dtype=dt)
            mma = im.int8_linear_blockscale_mma(gq, w2q, gs, w2s, b2, out_dtype=dt)
            torch_sync()
            name = (f"int8_linear_blockscale proj M={m} K={PROJ_SHAPE[0]} N={PROJ_SHAPE[1]} "
                    f"n_kb={gs.shape[0]} {dt}")
            worst["int8_linear_blockscale"] = max(worst["int8_linear_blockscale"],
                                                  _check_gemm(name, out, ref))
            _check_wgmma_equal(name, out, mma)
        x, gamma, beta, inv_a = producer_inputs(m, 768, dev, seed=3)
        q, sc = im.ln_quantize(x, gamma, beta)
        rq, rsc = im.ln_quantize_reference(x, gamma, beta)
        three = im.ln_quantize_static3(x.reshape(-1, s, 768), gamma, beta, inv_a)
        two = im.ln_quantize_static(x, gamma, beta, inv_a)
        torch_sync()
        worst["ln_quantize"] = max(worst["ln_quantize"],
                                   _int8_disagreement(f"ln_quantize M={m} D=768", q, rq))
        _check_scales(f"ln_quantize M={m} D=768", sc, rsc)
        equal = torch.equal(three.reshape(m, 768), two)
        print(f"  ln_quantize_static3 [{m // s}, {s}, 768] vs ln_quantize_static: bit for bit "
              f"{equal} (tolerance 0)")
        if not equal:
            raise AssertionError("ln_quantize_static3 differs from ln_quantize_static")
    return worst


def _timed_pairs(pairs: dict) -> dict:
    """plain, kernel, kernel, plain for each entry of ``pairs`` (name ->
    (kernel, plain, library call or None, composition, bound)), then the
    library call and the composition."""
    times = {}
    for name, (kernel, plain, lib, comp, bnd) in pairs.items():
        p1, k1, k2, p2 = _time_ms(plain), _time_ms(kernel), _time_ms(kernel), _time_ms(plain)
        lib_ms = _time_ms(lib) if lib is not None else None
        comp_ms = _time_ms(comp)
        times[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib_ms,
                       "composition_ms": comp_ms, **bnd}
        lib_text = f"torch._int_mm alone {lib_ms:.4f} ms" if lib_ms is not None else \
            "no single PyTorch call"
        print(f"  {name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, {lib_text}, "
              f"the xla tier's composition {comp_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']})")
    return times


def time_int8_gemm(im, quant, dev) -> dict:
    """The four kernels of the dynamic tiers at the vision tower's shapes (M =
    25,216): int8_linear at qkv and out, gelu_quant at fc, blockscale at proj
    (6 K blocks), ln_quantize; each bound from its bytes (each input read once,
    each output written once) and its int8 operations. The yardsticks:
    torch._int_mm alone at the same shape (the product only), and the xla
    tier's composition of the same step (torch._int_mm and the torch epilogue;
    for ln_quantize quant._ln_quant_rows). Each GEMM's mma.sync kernel (the
    _mma entries) is timed beside its wgmma one."""
    import torch

    b, s, _, _ = MAIN_SHAPES["vision"]
    m = b * s
    pairs, mma_sync = {}, {}
    for shape, (k, n) in GEMM_SHAPES.items():
        xq, wq, xs, ws, bias = gemm_inputs(im, m, k, n, dev, seed=4)
        mma_sync[f"int8_linear {shape}"] = lambda a=(xq, wq, xs, ws, bias): im.int8_linear_mma(*a)
        pairs[f"int8_linear {shape}"] = (
            lambda a=(xq, wq, xs, ws, bias): im.int8_linear(*a),
            lambda a=(xq, wq, xs, ws, bias): im.int8_linear_reference(*a),
            lambda a=(xq, wq): torch._int_mm(*a),
            lambda a=(xq, wq, xs, ws, bias): im.int8_linear_xla(*a),
            bound(m * k + k * n + m * 4 + 2 * n * 4 + m * n * 2, {"int8": 2 * m * k * n}))
    k, n = FC_SHAPE
    xq, wq, xs, ws, bias = gemm_inputs(im, m, k, n, dev, seed=5)
    gq, gs = im.int8_linear_gelu_quant(xq, wq, xs, ws, bias)
    pairs["int8_linear_gelu_quant fc"] = (
        lambda: im.int8_linear_gelu_quant(xq, wq, xs, ws, bias),
        lambda: im.int8_linear_gelu_quant_reference(xq, wq, xs, ws, bias),
        lambda: torch._int_mm(xq, wq),
        lambda: im.quantize_rows(im.int8_linear_xla(xq, wq, xs, ws, bias, activation="gelu")),
        bound(m * k + k * n + m * 4 + 2 * n * 4 + m * n + gs.numel() * 4, {"int8": 2 * m * k * n}))
    k2, n2 = PROJ_SHAPE
    _, w2q, _, w2s, b2 = gemm_inputs(im, 8, k2, n2, dev, seed=6)
    pairs["int8_linear_blockscale proj"] = (
        lambda: im.int8_linear_blockscale(gq, w2q, gs, w2s, b2),
        lambda: im.int8_linear_blockscale_reference(gq, w2q, gs, w2s, b2),
        lambda: torch._int_mm(gq, w2q),
        lambda: im.int8_linear_xla(gq, w2q, gs[0], w2s, b2),
        bound(m * k2 + k2 * n2 + gs.numel() * 4 + 2 * n2 * 4 + m * n2 * 2,
              {"int8": 2 * m * k2 * n2}))
    mma_sync["int8_linear_gelu_quant fc"] = lambda: im.int8_linear_gelu_quant_mma(xq, wq, xs, ws,
                                                                                 bias)
    mma_sync["int8_linear_blockscale proj"] = lambda: im.int8_linear_blockscale_mma(gq, w2q, gs,
                                                                                   w2s, b2)
    x, gamma, beta, _ = producer_inputs(m, 768, dev, seed=7)
    ln = {"scale": gamma, "bias": beta}
    pairs["ln_quantize"] = (
        lambda: im.ln_quantize(x, gamma, beta), lambda: im.ln_quantize_reference(x, gamma, beta),
        None, lambda: quant._ln_quant_rows(x, ln),
        bound(x.numel() * 2 + 2 * 768 * 4 + x.numel() + m * 4, {}))
    times = _timed_pairs(pairs)
    for name, fn in mma_sync.items():
        mma_sync_ms = (_time_ms(fn), _time_ms(fn))
        times[name]["mma_sync_ms"] = sum(mma_sync_ms) / 2
        print(f"  {name} on the mma.sync kernel (the one the wgmma kernel replaced): "
              f"{mma_sync_ms[0]:.4f}/{mma_sync_ms[1]:.4f} ms")
    return times


def torch_sync() -> None:
    import torch

    torch.cuda.synchronize()


def smoke_config(model_name: str, dtype: str, log_dir: str, **kw):
    from team_tpu_torch.config import Config

    extras = {"tiny_backbone": False, "dataset_kwargs": dict(DATASET), **kw.pop("extras", {})}
    return Config(prefix="chip_smoke", dataset="synthetic_insects", model_name=model_name,
                  convnet_type=kw.pop("convnet_type", "clip"), init_cls=2, increment=2,
                  batch_size=kw.pop("batch_size", 128),
                  seed=[1], shuffle=True, device=kw.pop("device", [0]), compute_dtype=dtype,
                  log_dir=log_dir,
                  extras=extras, **kw)


def start_span_report() -> None:
    """Reset the program's spans and switch them on, for a protocol run whose
    span report :func:`print_span_report` prints. Every other part of this
    script, the timed encode rates among them, runs with them off."""
    from team_tpu_torch.utils import phase_timer

    phase_timer.reset()
    phase_timer.enable(True)


def print_span_report() -> None:
    """Print the span report, indented, and switch the spans off again."""
    from team_tpu_torch.utils import phase_timer

    phase_timer.enable(False)
    for line in phase_timer.format_report().splitlines():
        print("    " + line)


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


def run_main_path(ms, log_dir: str) -> dict:
    """SimpleCIL (bf16) then ZS-CLIP (f32) through the trainer; launch counts
    are zeroed right before each run and read right after it."""
    from team_tpu_torch.trainer import train

    counts = {"launches": 0, "causal": 0}
    for model_name, dtype in (("simplecil", "bfloat16"), ("zs_clip", "float32")):
        start_span_report()
        ms.reset_launch_counts()
        t0 = time.perf_counter()
        res = train(smoke_config(model_name, dtype, os.path.join(log_dir, model_name)))
        wall = time.perf_counter() - t0
        launches, causal = ms.fused_mha_packed.launches, ms.fused_mha_packed.causal_launches
        print(f"  {model_name} ({dtype}): {wall:.2f} s, top1 per task {[float(a) for a in res['cnn_top1']]}, "
              f"top4 {[float(a) for a in res['cnn_top5']]}; kernel launches {launches} "
              f"(causal {causal}, non-causal {launches - causal})")
        print_span_report()
        if causal == 0 or launches - causal == 0:
            raise AssertionError(f"{model_name}: the main path did not launch the kernel for "
                                 "both towers")
        accs = list(res["cnn_top1"]) + list(res["cnn_top5"])
        if len(res["cnn_top1"]) != 2 or not all(0.0 <= float(a) <= 100.0 for a in accs):
            raise AssertionError(f"{model_name}: bad accuracy curve {res}")
        counts["launches"] += launches
        counts["causal"] += causal
    return counts


# the fused routes' phase-5 runs: (model, dtype, attention_impl, extra config)
FUSED_RUNS = (("proof", "bfloat16", "attn_block", {"batch_size": FLAGSHIP_BATCH, "tuned_epoch": 2}),
              ("simplecil", "bfloat16", "mha_packed_proj", {}),
              ("zs_clip", "float32", "attn_block", {}))


SIGLIP_FLASH_CALLS = 28  # a SigLIP encode: its 27 blocks and the attention-pool query


def _check_tower_bf16_launches(tb, tower: str) -> tuple:
    """The bf16 tower kernels' launches, set to 0 just before one B=128
    encode, against its ``TOWER_BF16_LAUNCHES``."""
    got = (tb.bias_act.launches, tb.residual_ln.launches, tb.layer_norm.launches)
    print(f"  {tower} bf16 encode: bias_act, residual_ln, layer_norm launched {got} times "
          f"(want {TOWER_BF16_LAUNCHES[tower]})")
    if got != TOWER_BF16_LAUNCHES[tower]:
        raise AssertionError(f"{tower}: the bf16 tower kernels launched {got} times, not "
                             f"{TOWER_BF16_LAUNCHES[tower]}")
    return got


def run_vitb16_bf16_path(tb) -> dict:
    """ViT-B/16 in bf16 through the learners' entry (``BackboneRuntime``,
    ``attention_impl`` auto): one B=128 encode of 224 px uint8 images must
    launch ``TOWER_BF16_LAUNCHES["vitb16"]`` of the elementwise kernels (the
    counters set to 0 just before it); its
    features are held to the same tower with the kernels switched off
    (``clip._tower_kernels``), the composition, at cosine >= TOWER_COS."""
    import numpy as np
    import torch

    from team_tpu_torch.backbone import clip
    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime

    params = clip.init_clip_params(torch.Generator().manual_seed(0), clip.CLIPConfig())
    rt = BackboneRuntime(smoke_config("simplecil", "bfloat16", ""), params=params)
    u8 = np.random.default_rng(1).integers(0, 256, (EVAL_B, 224, 224, 3), dtype=np.uint8)
    batch = rt.to_device(u8)
    rt.encode_image(batch)
    torch.cuda.synchronize()
    tb.reset_launch_counts()
    feats = rt.encode_image(batch)
    torch.cuda.synchronize()
    launches = _check_tower_bf16_launches(tb, "vitb16")
    kernels = clip._tower_kernels
    clip._tower_kernels = lambda x, shard=None: False
    try:
        plain = rt.encode_image(batch)
    finally:
        clip._tower_kernels = kernels
    cos = torch.nn.functional.cosine_similarity(feats.double(), plain.double(), dim=-1).min().item()
    print(f"  vitb16 bf16 encode: min cosine to the composition's tower {cos:.7f} (limit "
          f"{TOWER_COS})")
    if cos < TOWER_COS:
        raise AssertionError(f"vitb16 bf16: the tower kernels' features at cosine {cos}")
    return {"launches": launches, "cos_composition_min": cos}


def run_siglip_path(fa, tb, dev) -> dict:
    """SigLIP So400m/14-384 through the learners' entry: ``BackboneRuntime``
    with ``convnet_type`` siglip_so400m14_384, bf16, ``attention_impl`` auto.
    One B=128 encode of 384 px uint8 images, with the counters set to 0 just
    before it, must count 28 flash calls (``attention.flash_calls``) and add
    28 to ``flash_attention.launches``: no block and not the head fell back
    to the plain route; and launch ``TOWER_BF16_LAUNCHES["siglip"]`` of the
    elementwise kernels. Its features are held to the same tower on the plain
    route (``xla``) as the bf16 towers in phase 6."""
    import numpy as np
    import torch

    from team_tpu_torch.backbone.clip import CLIPConfig, init_clip_params
    from team_tpu_torch.learners.backbone_runtime import SIGLIP, BackboneRuntime
    from team_tpu_torch.utils import phase_timer

    params = init_clip_params(torch.Generator().manual_seed(0), CLIPConfig.siglip_so400m14_384())
    runtimes = {route: BackboneRuntime(smoke_config("simplecil", "bfloat16", "",
                                                    convnet_type=SIGLIP, attention_impl=route),
                                       params=params)
                for route in ("auto", "xla")}
    del params
    rt = runtimes["auto"]
    size = rt.clip_cfg.vision.image_size
    u8 = np.random.default_rng(0).integers(0, 256, (EVAL_B, size, size, 3), dtype=np.uint8)
    batch = rt.to_device(u8)
    rt.encode_image(batch)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    tb.reset_launch_counts()
    start_span_report()
    t0 = time.perf_counter()
    feats = rt.encode_image(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    calls = phase_timer.report()["counters"].get(phase_timer.FLASH_CALLS)
    launches = fa.flash_attention.launches
    print_span_report()
    tower_launches = _check_tower_bf16_launches(tb, "siglip")
    plain = runtimes["xla"].encode_image(batch)
    torch.cuda.synchronize()
    cos = torch.nn.functional.cosine_similarity(feats, plain, dim=-1).min().item()
    print(f"  SigLIP So400m/14-384, bf16, auto: one B={EVAL_B} encode (spans on) {1e3 * wall:.1f} "
          f"ms; attention.flash_calls {calls}, flash launches {launches} (want "
          f"{SIGLIP_FLASH_CALLS}); features {tuple(feats.shape)}, min cosine to the plain "
          f"route {cos:.6f}")
    if calls != SIGLIP_FLASH_CALLS or launches != SIGLIP_FLASH_CALLS:
        raise AssertionError(f"SigLIP encode: {calls} flash calls and {launches} launches, "
                             f"not {SIGLIP_FLASH_CALLS}: an attention left the flash kernel")
    if (tuple(feats.shape) != (EVAL_B, rt.out_dim) or feats.dtype != torch.float32
            or not torch.isfinite(feats).all() or cos < 0.99):
        raise AssertionError(f"SigLIP features: shape {tuple(feats.shape)}, {feats.dtype}, "
                             f"min cosine to the plain route {cos}")
    return {"flash_calls": calls, "launches": launches, "wall_ms": 1e3 * wall,
            "cos_plain_min": cos, "tower_bf16_launches": tower_launches}


def run_fused_paths(ms, fa, log_dir: str) -> dict:
    """PROOF (bf16) on attn_block, SimpleCIL (bf16) on mha_packed_proj and
    ZS-CLIP (f32) on attn_block through the trainer. Every block of every
    tower call goes through the route's kernel: its launches must equal the
    layers times the image-tower calls (non-causal) and times the text-tower
    calls (causal), both non-zero; attn_block's second kernel launches once
    with each first; the packed and flash kernels launch no time."""
    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime
    from team_tpu_torch.trainer import train

    results = {}
    for model_name, dtype, impl, kw in FUSED_RUNS:
        calls = {"image": 0, "text": 0}

        def count_towers(rt):
            for key, attr in (("image", "encode_image"), ("text", "encode_text_tokens")):
                setattr(rt, attr, _counted(getattr(rt, attr), calls, key))

        cfg = smoke_config(model_name, dtype, os.path.join(log_dir, f"{model_name}_{impl}"),
                           attention_impl=impl, **kw)
        start_span_report()
        with recording(BackboneRuntime, count_towers) as made:
            ms.reset_launch_counts()
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            res = train(cfg)
            wall = time.perf_counter() - t0
            block, proj = ms.fused_attn_block, ms.fused_mha_packed_proj
            got = {"attn_block": block.launches, "attn_block_causal": block.causal_launches,
                   "attn_block_proj": block.proj_launches, "mha_packed_proj": proj.launches,
                   "mha_packed_proj_causal": proj.causal_launches,
                   "fused_mha_packed": ms.fused_mha_packed.launches,
                   "flash_attention": fa.flash_attention.launches,
                   "fused_mha_short": ms.fused_mha_short.launches}
        layers = made[0].clip_cfg.vision.layers if made else 0
        n = layers * (calls["image"] + calls["text"])
        causal = layers * calls["text"]
        want = dict.fromkeys(got, 0)
        if impl == "attn_block":
            want.update(attn_block=n, attn_block_causal=causal, attn_block_proj=n)
        else:
            want.update(mha_packed_proj=n, mha_packed_proj_causal=causal)
        print(f"  {model_name} ({dtype}, attention_impl {impl}"
              f"{', batch %d' % kw['batch_size'] if 'batch_size' in kw else ''}): {wall:.2f} s, "
              f"top1 per task {[float(a) for a in res['cnn_top1']]}, top4 "
              f"{[float(a) for a in res['cnn_top5']]}; {calls['image']} image-tower and "
              f"{calls['text']} text-tower calls of {layers} layers; launches {got}")
        print_span_report()
        if len(made) != 1 or got != want or calls["image"] == 0 or calls["text"] == 0:
            raise AssertionError(f"{model_name} on {impl}: launches {got}, want {want} (each "
                                 "block of each tower call through the route's kernel, causal "
                                 "and non-causal non-zero, no packed or flash launch)")
        accs = list(res["cnn_top1"]) + list(res["cnn_top5"])
        if len(res["cnn_top1"]) != 2 or not all(0.0 <= float(a) <= 100.0 for a in accs):
            raise AssertionError(f"{model_name} on {impl}: bad accuracy curve {res}")
        results[f"{model_name}_{impl}"] = {"launches": got, "image_calls": calls["image"],
                                           "text_calls": calls["text"], "wall_s": wall}
    return results


def run_int8_path(ms, log_dir: str, cache_dir: str) -> dict:
    """SimpleCIL (bf16) on the int8 static tier through the trainer: it must
    commit the quantized tower, and every int8 batch runs the integer-QK^T
    kernel in 11 blocks and the CLS kernel in the last."""
    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime
    from team_tpu_torch.ops import int8_matmul as im
    from team_tpu_torch.trainer import train

    cfg = smoke_config("simplecil", "bfloat16", os.path.join(log_dir, "simplecil_int8"),
                       batch_size=FLAGSHIP_BATCH, encoder_quant="int8_static",
                       extras={"int8_cache_dir": cache_dir})
    start_span_report()
    with recording(BackboneRuntime) as made:
        ms.reset_launch_counts()
        im.reset_launch_counts()
        t0 = time.perf_counter()
        res = train(cfg)
        wall = time.perf_counter() - t0
        q3i, cls = ms.fused_mha_packed_q3i.launches, ms.fused_mha_packed_q3i_cls.launches
        packed = ms.fused_mha_packed.launches
        epilogues = {name: getattr(im, name).launches for name in STATIC3D_EPILOGUES(1)}
    print(f"  simplecil (int8_static, batch {FLAGSHIP_BATCH}): {wall:.2f} s, top1 per task {[float(a) for a in res['cnn_top1']]}, "
          f"top4 {[float(a) for a in res['cnn_top5']]}; launches q3i {q3i}, q3i_cls {cls}, "
          f"packed bf16 {packed} (calibration, gate and text), epilogues {epilogues}")
    print_span_report()
    if len(made) != 1:
        raise AssertionError(f"expected one backbone runtime, got {len(made)}")
    rt = made[0]
    print(f"  held-out gate: min cosine {rt.gate_cosine} (limit 0.999); committed {rt.int8_committed}")
    if not rt.int8_committed or rt.encoder_quant != "int8_static":
        raise AssertionError("the int8 path fell back to bf16: the quantized tower was not committed")
    layers = rt.clip_cfg.vision.layers
    if cls == 0 or q3i != (layers - 1) * cls:
        raise AssertionError(f"int8 launches: q3i {q3i}, q3i_cls {cls}; want {layers - 1} and 1 "
                             "per int8 batch, both non-zero")
    want = {name: k * cls for name, k in STATIC3D_EPILOGUES(layers).items()}
    if epilogues != want:
        raise AssertionError(f"int8 epilogue launches {epilogues}, want {want} "
                             f"({STATIC3D_EPILOGUES(layers)} per int8 batch)")
    accs = list(res["cnn_top1"]) + list(res["cnn_top5"])
    if len(res["cnn_top1"]) != 2 or not all(0.0 <= float(a) <= 100.0 for a in accs):
        raise AssertionError(f"simplecil int8: bad accuracy curve {res}")
    return {"q3i": q3i, "q3i_cls": cls, "gate_cosine": rt.gate_cosine}


def _counted(fn, calls: dict, key: str):
    """``fn`` that adds one to ``calls[key]`` on each call."""
    def wrapped(*args, **kwargs):
        calls[key] += 1
        return fn(*args, **kwargs)
    return wrapped


def run_int8_routes(ms, im, log_dir: str, cache_root: str) -> dict:
    """SimpleCIL (bf16) through the trainer on each run of INT8_ROUTES (its
    route under its knobs), each with its own payload cache: it must commit
    the quantized tower, and each kernel of the route must launch exactly its
    count in every int8 batch (the packed kernel also once per block of each
    calibration forward, which is the bf16 tower), and no other int8 kernel
    may launch."""
    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime
    from team_tpu_torch.trainer import train

    counters = {"ln_quantize_static": im.ln_quantize_static, "row_quant_static": im.row_quant_static,
                "ln_quant_folded": im.ln_quant_folded, "static_requant": im.static_requant,
                "static_residual": im.static_residual,
                "fused_mha_packed_q": ms.fused_mha_packed_q,
                "fused_mha_packed_q3": ms.fused_mha_packed_q3,
                **{name: getattr(ms, name) for name in Q3I_COUNTERS}}
    results = {}
    for run, (route, env, per_batch_of) in INT8_ROUTES.items():
        calls = {"int8": 0, "calib": 0}

        def count_encodes(rt):
            for key, attr in (("int8", "_encode_int8"), ("calib", "_calib_forward")):
                setattr(rt, attr, _counted(getattr(rt, attr), calls, key))

        cfg = smoke_config("simplecil", "bfloat16", os.path.join(log_dir, f"simplecil_{run}"),
                           batch_size=FLAGSHIP_BATCH, encoder_quant="int8_static",
                           extras={"int8_cache_dir": os.path.join(cache_root, run),
                                   "int8_gemm_impl": route})
        start_span_report()
        with recording(BackboneRuntime, count_encodes) as made, knobs(env):
            ms.reset_launch_counts()
            im.reset_launch_counts()
            t0 = time.perf_counter()
            res = train(cfg)
            wall = time.perf_counter() - t0
            got = {name: fn.launches for name, fn in counters.items()}
            got["fused_mha_packed"] = ms.fused_mha_packed.launches - ms.fused_mha_packed.causal_launches
        rt = made[0]
        print(f"  simplecil (int8_static, int8_gemm_impl {route}{''.join(f', {k}={v}' for k, v in env.items())}, "
              f"batch {FLAGSHIP_BATCH}): "
              f"{wall:.2f} s, top1 per task {[float(a) for a in res['cnn_top1']]}; held-out gate "
              f"min cosine {rt.gate_cosine} (limit 0.999), committed {rt.int8_committed}; "
              f"{calls['int8']} int8 batches, {calls['calib']} calibration forwards; launches {got}")
        print_span_report()
        if len(made) != 1 or not rt.int8_committed or rt.encoder_quant != "int8_static":
            raise AssertionError(f"{run}: the int8 path fell back to bf16: the quantized tower "
                                 "was not committed")
        layers = rt.clip_cfg.vision.layers
        per_batch = per_batch_of(layers)
        want = {name: calls["int8"] * per_batch.get(name, 0) for name in got}
        want["fused_mha_packed"] += layers * calls["calib"]
        print(f"    per int8 batch: {per_batch}")
        if calls["int8"] == 0 or got != want or not all(got[n] for n in per_batch):
            raise AssertionError(f"{run}: launches {got}, want {want} ({per_batch} per int8 "
                                 "batch), each of the route's kernels non-zero")
        accs = list(res["cnn_top1"]) + list(res["cnn_top5"])
        if len(res["cnn_top1"]) != 2 or not all(0.0 <= float(a) <= 100.0 for a in accs):
            raise AssertionError(f"simplecil {run}: bad accuracy curve {res}")
        results[run] = {"launches": got, "per_int8_batch": per_batch,
                          "int8_batches": calls["int8"], "gate_cosine": rt.gate_cosine,
                          "wall_s": wall}
    return results


def run_int8_dynamic_tiers(ms, im, log_dir: str, cache_root: str) -> dict:
    """SimpleCIL (bf16) through the trainer on int8_gemm_impl hybrid and
    pallas at batch 16, each with its own payload cache. As in team_tpu the
    runtime builds the static payload and gates it through the tier's blocks:
    the decision must follow the rule (min cosine >= 0.999 commits, else bf16
    from then on), and each of the tier's kernels must launch exactly its
    count per block in every int8 batch (the gate batch, and every later one
    if it committed), with no other int8 kernel."""
    from team_tpu_torch.learners.backbone_runtime import GATE_MIN_COSINE, BackboneRuntime
    from team_tpu_torch.trainer import train

    others = {"ln_quantize_static": im.ln_quantize_static, "row_quant_static": im.row_quant_static,
              **{name: getattr(ms, name) for name in Q3I_COUNTERS}}
    results = {}
    for tier, per_block in TIER_PER_BLOCK.items():
        calls = {"int8": 0, "calib": 0}

        def count_encodes(rt):
            for key, attr in (("int8", "_encode_int8"), ("calib", "_calib_forward")):
                setattr(rt, attr, _counted(getattr(rt, attr), calls, key))

        cfg = smoke_config("simplecil", "bfloat16", os.path.join(log_dir, f"simplecil_{tier}"),
                           batch_size=FLAGSHIP_BATCH, encoder_quant="int8_static",
                           extras={"int8_cache_dir": os.path.join(cache_root, tier),
                                   "int8_gemm_impl": tier})
        start_span_report()
        with recording(BackboneRuntime, count_encodes) as made:
            ms.reset_launch_counts()
            im.reset_launch_counts()
            t0 = time.perf_counter()
            res = train(cfg)
            wall = time.perf_counter() - t0
            got = {name: getattr(im, name).launches for name in TIER_KERNELS}
            stray = {name: fn.launches for name, fn in others.items() if fn.launches}
        rt = made[0]
        passed = rt.gate_cosine is not None and rt.gate_cosine >= GATE_MIN_COSINE
        print(f"  simplecil (int8_static, int8_gemm_impl {tier}, batch {FLAGSHIP_BATCH}): "
              f"{wall:.2f} s, top1 per task {[float(a) for a in res['cnn_top1']]}; held-out gate "
              f"min cosine {rt.gate_cosine} (limit {GATE_MIN_COSINE}): "
              f"{'commits' if passed else 'serves bf16'}; committed {rt.int8_committed}, "
              f"serving {rt.encoder_quant}; {calls['int8']} int8 batches, {calls['calib']} "
              f"calibration forwards; launches {got}")
        print_span_report()
        served = "int8_static" if passed else "bf16"
        if len(made) != 1 or rt.int8_committed != passed or rt.encoder_quant != served \
                or (calls["int8"] == 1) == passed:
            raise AssertionError(f"{tier}: the gate's decision ({rt.gate_cosine}) and what the "
                                 "run served disagree with the >= 0.999 rule")
        layers = rt.clip_cfg.vision.layers
        want = {name: calls["int8"] * layers * n for name, n in per_block.items()}
        if calls["int8"] == 0 or got != want or stray:
            raise AssertionError(f"{tier}: launches {got} (others {stray}), want {want} "
                                 f"({per_block} per block of each int8 batch)")
        accs = list(res["cnn_top1"]) + list(res["cnn_top5"])
        if len(res["cnn_top1"]) != 2 or not all(0.0 <= float(a) <= 100.0 for a in accs):
            raise AssertionError(f"simplecil {tier}: bad accuracy curve {res}")
        results[tier] = {"launches": got, "int8_batches": calls["int8"],
                         "gate_cosine": rt.gate_cosine, "committed": passed, "wall_s": wall}
    return results


def run_proof_path(ms, fa, log_dir: str) -> dict:
    """PROOF (bf16) with attention_impl="pallas" through the trainer: every
    attention of both towers goes through the flash kernel. Then PROOF's loss
    on a batch of its own train features, on the card against the CPU."""
    from team_tpu_torch.learners import proof as proof_learner
    from team_tpu_torch.trainer import train

    cfg = smoke_config("proof", "bfloat16", os.path.join(log_dir, "proof"),
                       batch_size=FLAGSHIP_BATCH, attention_impl="pallas", tuned_epoch=2)
    losses = []

    def record_losses(learner):
        learner._epoch_stats_hook = lambda task, epoch, st: losses.append((task, epoch, st))

    start_span_report()
    with recording(proof_learner.Learner, record_losses) as made:
        ms.reset_launch_counts()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        res = train(cfg)
        wall = time.perf_counter() - t0
        flash, causal, packed = (fa.flash_attention.launches,
                                 fa.flash_attention.causal_launches, ms.fused_mha_packed.launches)
    model = made[0]
    for task, epoch, st in losses:
        print(f"  proof task {task} epoch {epoch}: summed over {st['n']} samples: total "
              f"{st['total']:.6f}, ce {st['ce']:.6f}, clip {st['clip']:.6f}, unicl {st['unicl']:.6f}; "
              f"train correct {st['correct']}")
    if len(losses) != 4 or not all(math.isfinite(st[k]) for _, _, st in losses
                                   for k in ("total", "ce", "clip", "unicl")):
        raise AssertionError(f"proof: expected finite losses for 2 tasks x 2 epochs, got {losses}")
    print(f"  proof (bf16, attention_impl=pallas, batch {FLAGSHIP_BATCH}, tuned_epoch 2): "
          f"{wall:.2f} s, top1 per task {[float(a) for a in res['cnn_top1']]}, top4 "
          f"{[float(a) for a in res['cnn_top5']]}, nme top1 {[float(a) for a in res['nme_top1']]}; "
          f"flash launches {flash} (causal {causal}, non-causal {flash - causal}), packed {packed}")
    print_span_report()
    if len(made) != 1:
        raise AssertionError(f"expected one PROOF learner, got {len(made)}")
    if causal == 0 or flash - causal == 0:
        raise AssertionError("proof: the main path did not launch the flash kernel in both towers")
    accs = list(res["cnn_top1"]) + list(res["cnn_top5"]) + list(res["nme_top1"])
    if len(res["cnn_top1"]) != 2 or not all(0.0 <= float(a) <= 100.0 for a in accs):
        raise AssertionError(f"proof: bad accuracy curve {res}")
    return {"flash": flash, "causal": causal, "wall_s": wall, **check_proof_loss(model),
            **profile_proof_steps(model)}


def time_first_optimizer() -> dict:
    """In a fresh process: the seconds ``import torch._dynamo`` takes after
    ``import torch``, then the first ``torch.optim.AdamW`` construction after
    it; PROOF's ``make_optimizer`` phase pays both in one."""
    code = ("import time, torch\n"
            "t0 = time.perf_counter(); import torch._dynamo; t1 = time.perf_counter()\n"
            "torch.optim.AdamW([torch.nn.Parameter(torch.zeros(4))], lr=1e-3)\n"
            "print(t1 - t0, time.perf_counter() - t1)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    dynamo_s, adamw_s = (float(x) for x in out.stdout.split())
    print(f"  fresh process: import torch._dynamo {dynamo_s:.3f} s, then the first AdamW "
          f"{adamw_s:.3f} s")
    return {"import_dynamo_s": dynamo_s, "first_adamw_s": adamw_s}


def profile_proof_steps(model, n: int = 10) -> dict:
    """torch.profiler over ``n`` train steps of the trained learner (a fresh
    AdamW on its parameters, its own features): device kernel time against
    wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from team_tpu_torch.learners import proof_net as pn

    feats, labels, stages = model._train_feats
    to = model.backbone.to_device
    batch = {"feat": to(feats[:FLAGSHIP_BATCH].astype("float32")),
             "label": to(labels[:FLAGSHIP_BATCH].astype("int64")),
             "stage_id": to(stages[:FLAGSHIP_BATCH].astype("int64")),
             "valid_mask": torch.ones(FLAGSHIP_BATCH, device=model.device)}
    opt = pn.make_optimizer(model.cfg, pn.trainable_leaves(model.trainable))

    def step():
        pn.train_step(model.trainable, opt, batch, model.ctx, model.buffers, 1, model._loss_kwargs,
                      generator=model._dropout_gen)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    device = sum(e.self_device_time_total for e in kernels) / 1e6 / n
    launches = sum(e.count for e in kernels) / n
    print(f"  proof train step (batch {FLAGSHIP_BATCH}, profiled, {n} steps): wall {1e3 * wall:.3f} ms, "
          f"device kernel time {1e3 * device:.3f} ms ({100 * device / wall:.1f} % busy), "
          f"{launches:.0f} kernel launches per step")
    return {"step_ms": 1e3 * wall, "step_device_ms": 1e3 * device}


def check_proof_loss(model) -> dict:
    """The trained learner's loss, its parts and its gradients on one batch of
    its train features, with fixed dropout keeps, on the card and on the CPU
    (float32, TF32 off): they agree within 1e-4 relative."""
    import torch

    from team_tpu_torch.bridge import tree_to
    from team_tpu_torch.learners import proof_net as pn
    from team_tpu_torch.modules.fusion import draw_keep_masks

    feats, labels, stages = model._train_feats
    n = min(FLAGSHIP_BATCH, len(labels))
    batch = {"feat": torch.from_numpy(feats[:n].astype("float32")),
             "label": torch.from_numpy(labels[:n].astype("int64")),
             "stage_id": torch.from_numpy(stages[:n].astype("int64")),
             "valid_mask": torch.ones(n)}
    d = model.dims.feature_dim
    keeps = draw_keep_masks(n, 3 + model.dims.max_classes + model.dims.max_tasks * model.dims.ctx_len,
                            d, 1, 0.1, torch.Generator().manual_seed(0), "cpu")
    def leaves_on(tree, dev):
        if isinstance(tree, dict):
            return {k: leaves_on(v, dev) for k, v in tree.items()}
        return tree.detach().to(dev).clone().requires_grad_(True)

    out = {}
    for dev in (model.device, torch.device("cpu")):
        tr = leaves_on(model.trainable, dev)
        leaves = pn.trainable_leaves(tr)
        ctx = pn.TaskContext(*(t.to(dev) for t in model.ctx))
        buffers = pn.ProofBuffers(*(t.to(dev) for t in model.buffers))
        loss, st = pn.proof_loss(tr, tree_to(batch, dev), ctx, buffers, 1,
                                 keep_masks=tuple(m.to(dev) for m in keeps), **model._loss_kwargs)
        loss.backward()
        out[dev.type] = ([float(t.detach()) for t in st[:4]], torch.cat([x.grad.flatten().cpu() for x in leaves]))
    (card, g_card), (cpu, g_cpu) = out["cuda"], out["cpu"]
    rel = max(abs(a - b) / max(abs(b), 1e-6) for a, b in zip(card, cpu))
    grad_rel = float((g_card - g_cpu).abs().max() / g_cpu.abs().max().clamp_min(1e-12))
    print(f"  proof loss on the card vs the CPU (batch {n}, total/ce/clip/unicl): {card} vs {cpu}; "
          f"max relative difference {rel:.3e}, gradients {grad_rel:.3e} of their max (limit 1e-4)")
    if not all(math.isfinite(x) for x in card) or rel > 1e-4 or grad_rel > 1e-4:
        raise AssertionError("proof loss on the card disagrees with the CPU")
    return {"loss_rel_diff": rel, "grad_rel_diff": grad_rel}


def _encode_rate(rt, images, n: int = 10) -> float:
    import torch

    batch = rt.to_device(_eval_batch(images))
    rt.encode_image(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        rt.encode_image(batch)
    torch.cuda.synchronize()
    return n * EVAL_B / (time.perf_counter() - t0)


def _eval_batch(images):
    import numpy as np

    return np.stack([images[i % len(images)] for i in range(EVAL_B)])


def check_features(im, dev, cache_dir: str, cache_root: str) -> dict:
    """The kernel-path towers against the plain-attention towers (same random
    weights) on a small batch of the smoke dataset; the int8 tower, loaded
    from the main path's cache, against itself with the plain kernels and
    against the bf16 tower; each run of INT8_ROUTES, loaded from its own
    cache, and each configuration of SERVED, loaded from another run's cache
    (under its knobs, with the q3i kernels' launches per encode counted),
    against itself with the plain kernels; and the encode rates."""
    import numpy as np
    import torch

    from team_tpu_torch.backbone.clip import CLIPConfig, init_clip_params
    from team_tpu_torch.data import DataManager
    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime
    from team_tpu_torch.ops import mha_short as ms

    dm = DataManager("synthetic_insects", True, 1, 2, 2, **DATASET)
    images = np.stack(dm.get_dataset(np.arange(4), source="test", mode="test").images[:8])
    prompts = [t.format(c) for c in dm._class_to_label for t in dm._data_to_prompt]
    params = init_clip_params(torch.Generator().manual_seed(0), CLIPConfig.vit_b16())
    rates = {}
    bf16_img = None
    routes = {"auto": "packed kernel", "pallas": "flash kernel"}
    for dtype, min_cos in (("float32", 0.99999), ("bfloat16", 0.99)):
        plain = BackboneRuntime(smoke_config("simplecil", dtype, "", attention_impl="xla"),
                                params=params)
        img_ref = plain.encode_image(plain.to_device(images))
        txt_ref = plain.encode_texts(prompts, cache=False)
        for route, kernel in routes.items():
            rt = BackboneRuntime(smoke_config("simplecil", dtype, "", attention_impl=route),
                                 params=params)
            img = rt.encode_image(rt.to_device(images))
            txt = rt.encode_texts(prompts, cache=False)
            for name, a, b in (("image", img, img_ref), ("text", txt, txt_ref)):
                if a.shape != (len(b), rt.out_dim) or not bool(torch.isfinite(a).all()):
                    raise AssertionError(f"{dtype} {name} features: shape {tuple(a.shape)} or "
                                         "not finite")
                cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
                err = (a - b).abs().max().item()
                print(f"  {dtype} {name} features through the {kernel} vs plain attention: "
                      f"min cosine {cos:.7f} (limit {min_cos}), max abs diff {err:.3e}")
                if cos < min_cos:
                    raise AssertionError(f"{dtype} {name} features disagree with the plain tower")
            key = dtype if route == "auto" else f"{dtype}_flash"
            if dtype == "bfloat16" and route == "auto":
                bf16_img = img
            if route == "auto" or dtype == "bfloat16":
                rates[key] = _encode_rate(rt, images)
                print(f"  encode {dtype} through the {kernel}: {rates[key]:.1f} img/s "
                      f"(B={EVAL_B}, 224x224 uint8 in, ViT-B/16 image tower)")
    short_launches = _fused_route_features(params, images, prompts, rates)
    runtimes, served_launches = {}, {}

    def cache_of(run):
        return cache_dir if run == "static3d_qi" else os.path.join(cache_root, run)

    configs = {"static3d_qi": ("static3d_qi", {}, cache_dir, None),
               **{run: (route, env, cache_of(run), None)
                  for run, (route, env, _) in INT8_ROUTES.items()},
               **{name: (route, env, cache_of(src), per_encode)
                  for name, (src, route, env, per_encode) in SERVED.items()}}
    for name, (route, env, cache, per_encode) in configs.items():
        with knobs(env):
            rates.update(_check_int8_config(ms, name, route, cache, per_encode, images, bf16_img,
                                            runtimes, served_launches))
    rates["int8_xla"] = _xla_tier(ms, params, images, bf16_img)
    tiers = _dynamic_tiers(im, params, images, bf16_img, dev)
    rates.update({f"int8_{tier}": t["rate"] for tier, t in tiers.items()})
    text = _text_tower_int8(params, prompts, dev)
    return rates, runtimes, short_launches, served_launches, tiers, text


def _xla_tier(ms, params, images, bf16_img) -> float:
    """The dynamic xla tier through the library API, on the dynamic payload
    of quantize_vision_tower (the runtime gates only the static payload,
    which fails there as in team_tpu): its packed-kernel launches in one
    encode (one a block), its features against the same tier with the
    packed kernel's plain version and against the bf16 tower, and its encode
    rate at the eval batch."""
    import torch

    from team_tpu_torch.backbone import quant
    from team_tpu_torch.backbone.clip import CLIPConfig
    from team_tpu_torch.bridge import tree_to
    from team_tpu_torch.ops.preprocess import preprocess_batch

    cfg = CLIPConfig.vit_b16()
    dev = torch.device("cuda", 0)
    qv = quant.quantize_vision_tower(tree_to(params, dev))

    def encode(u8):  # uint8 images already on the card, as _encode_rate's
        x = preprocess_batch(u8, cfg.vision.image_size)
        return quant.encode_image_int8(qv, x, cfg, gemm_impl="xla")

    small = torch.from_numpy(images).to(dev)
    ms.reset_launch_counts()
    img = encode(small)
    launches = ms.fused_mha_packed.launches
    saved = quant.attention_core
    quant.attention_core = lambda qkv, heads, *, causal, kv_len, impl: \
        ms.mha_packed_reference(qkv, heads, causal, kv_len)
    try:
        plain = encode(small)
    finally:
        quant.attention_core = saved
    cos = torch.nn.functional.cosine_similarity(img, plain, dim=-1).min().item()
    cos_bf16 = torch.nn.functional.cosine_similarity(img, bf16_img, dim=-1).min().item()
    print(f"  int8 xla (dynamic payload): {launches} packed-kernel launches in one encode (want "
          f"{cfg.vision.layers}); features vs the packed kernel's plain version: min cosine "
          f"{cos:.7f} (limit 0.9999); vs the bf16 tower: min cosine {cos_bf16:.7f}")
    if launches != cfg.vision.layers or cos < 0.9999 or not bool(torch.isfinite(img).all()):
        raise AssertionError("the xla tier through the packed kernel disagrees with its plain "
                             "version or missed the kernel")
    batch = torch.from_numpy(_eval_batch(images)).to(dev)
    encode(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        encode(batch)
    torch.cuda.synchronize()
    rate = 10 * EVAL_B / (time.perf_counter() - t0)
    print(f"  encode int8 xla: {rate:.1f} img/s (B={EVAL_B}, 224x224 uint8 in, ViT-B/16 image tower)")
    return rate


def _plain_tier_fns() -> dict:
    """The plain versions of the dynamic tiers' kernels and of the packed
    attention, by the name ``quant`` calls them under."""
    from team_tpu_torch.ops import int8_matmul as im
    from team_tpu_torch.ops import mha_short as ms

    return {**{name: getattr(im, name + "_reference") for name in TIER_KERNELS},
            "attention_core": lambda qkv, heads, *, causal, kv_len, impl:
                ms.mha_packed_reference(qkv, heads, causal, kv_len)}


def _swapped(fns: dict, run):
    """``run()`` with ``fns`` in place of the functions of those names in
    ``quant`` (same payload, same card)."""
    from team_tpu_torch.backbone import quant

    saved = {name: getattr(quant, name) for name in fns}
    for name, fn in fns.items():
        setattr(quant, name, fn)
    try:
        return run()
    finally:
        for name, fn in saved.items():
            setattr(quant, name, fn)


def _tier_kernels_on_tower_inputs(run, label: str):
    """``run()`` through the kernels, with every call of the dynamic tiers'
    kernels held against its plain version on the same inputs (the tower's
    own activations): int8 outputs at most one step apart on under
    INT8_MAX_FRAC of them, scales within 1e-6 relative, bf16 outputs within
    one bf16 step (2^-7 |ref|) plus 1e-5 of the largest |ref|."""
    import torch

    from team_tpu_torch.backbone import quant

    plain = _plain_tier_fns()
    stats = {}

    def checked(name, kernel):
        def call(*args, **kwargs):
            out = kernel(*args, **kwargs)
            ref = plain[name](*args, **kwargs)
            outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
            st = stats.setdefault(name, {"steps": 0, "n_diff": 0, "n": 0, "scale_rel": 0.0,
                                         "bf16_ok": True})
            for o, r in zip(outs, refs):
                if o.dtype == torch.int8:
                    diff = (o.int() - r.int()).abs()
                    st["steps"] = max(st["steps"], int(diff.max().item()))
                    st["n_diff"] += int((diff > 0).sum())
                    st["n"] += diff.numel()
                elif o.dtype == torch.float32:
                    st["scale_rel"] = max(st["scale_rel"], ((o - r).abs() / r.abs()).max().item())
                else:
                    err = (o.float() - r.float()).abs()
                    limit = BF16_STEP * r.float().abs() + 1e-5 * r.float().abs().max()
                    st["bf16_ok"] &= bool((err <= limit).all())
            return out
        return call

    out = _swapped({n: checked(n, getattr(quant, n)) for n in TIER_KERNELS}, run)
    for name, st in stats.items():
        frac = st["n_diff"] / st["n"] if st["n"] else 0.0
        print(f"    {label}, {name} on the tower's own inputs: max |diff| {st['steps']} int8 steps "
              f"on {100 * frac:.5f} % of {st['n']}, scales {st['scale_rel']:.2e} relative, bf16 "
              f"within one step {st['bf16_ok']}")
        if st["steps"] > 1 or frac >= INT8_MAX_FRAC or st["scale_rel"] > 1e-6 or not st["bf16_ok"]:
            raise AssertionError(f"{label}: {name} disagrees with its plain version on the "
                                 "tower's inputs")
    return out


def _dynamic_tiers(im, params, images, bf16_img, dev) -> dict:
    """hybrid and pallas through the library API on the dynamic payload of
    quantize_vision_tower at full width: every kernel call held against its
    plain version on the tower's inputs, the kernels' launches in one encode
    exact, the features against the same tier with the plain versions and
    against the bf16 tower, and the encode rate at the eval batch."""
    import torch

    from team_tpu_torch.backbone import quant
    from team_tpu_torch.backbone.clip import CLIPConfig
    from team_tpu_torch.bridge import tree_to
    from team_tpu_torch.ops.preprocess import preprocess_batch

    cfg = CLIPConfig.vit_b16()
    qv = quant.quantize_vision_tower(tree_to(params, dev))
    small = torch.from_numpy(images).to(dev)
    batch = torch.from_numpy(_eval_batch(images)).to(dev)
    out = {}
    for tier, per_block in TIER_PER_BLOCK.items():
        def encode(u8, tier=tier):  # uint8 images already on the card, as _encode_rate's
            return quant.encode_image_int8(qv, preprocess_batch(u8, cfg.vision.image_size), cfg,
                                           gemm_impl=tier)

        im.reset_launch_counts()
        img = encode(small)
        launches = {name: getattr(im, name).launches for name in TIER_KERNELS}
        want = {name: cfg.vision.layers * n for name, n in per_block.items()}
        checked = _tier_kernels_on_tower_inputs(lambda: encode(small), f"int8 {tier}")
        plain = _swapped(_plain_tier_fns(), lambda: encode(small))
        cos = torch.nn.functional.cosine_similarity(img, plain, dim=-1).min().item()
        cos_bf16 = torch.nn.functional.cosine_similarity(img, bf16_img, dim=-1).min().item()
        print(f"  int8 {tier} (dynamic payload, library API): launches in one encode {launches} "
              f"(want {want}); features vs the plain versions: min cosine {cos:.7f} (limit "
              f"0.9999); vs the bf16 tower: min cosine {cos_bf16:.7f}")
        if launches != want or cos < 0.9999 or not bool(torch.isfinite(img).all()) \
                or not torch.equal(checked, img):
            raise AssertionError(f"the {tier} tier through its kernels disagrees with its plain "
                                 "versions or missed a kernel")
        encode(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            encode(batch)
        torch.cuda.synchronize()
        rate = 10 * EVAL_B / (time.perf_counter() - t0)
        print(f"  encode int8 {tier}: {rate:.1f} img/s (B={EVAL_B}, 224x224 uint8 in, ViT-B/16 "
              "image tower)")
        out[tier] = {"rate": rate, "launches": launches, "cos_plain": cos, "cos_bf16": cos_bf16,
                     "encode": encode, "batch": batch}
    return out


def _text_tower_int8(params, prompts, dev) -> dict:
    """encode_text_int8 at full width on the class prompts: xla, hybrid and
    pallas on the dynamic text payload, static3d_qi on the prompt-set payload;
    each against the bf16 text tower (min cosine >= 0.99) and against itself
    with the plain versions of its kernels, with the dynamic tiers' launches
    exact and each of their kernel calls held against its plain version on
    the tower's own inputs. Against the plain versions the dynamic tiers and
    static3d_qi are held to cosine >= 0.9995, xla to 0.9999: ln_quantize's
    scales differ from its plain version's by a few ulps (its f32 sums run in
    another order), which moves the bf16 rounding of some of the next GEMM's
    outputs in a block, and 12 causal blocks carry that to the
    pooled token (0.9997708 at 8 prompts, NVIDIA H100 80GB HBM3, 700.00 W);
    static3d_qi's ln_quant_folded sums in another order too, and against the
    plain versions of its attention kernels alone it is held to 0.9999.
    The tower with only ln_quantize's plain version in place is printed
    beside it, to show where the drift comes from."""
    import torch

    from team_tpu_torch.backbone import quant
    from team_tpu_torch.backbone.clip import CLIPConfig, cast_frozen_params, encode_text
    from team_tpu_torch.backbone.tokenizer import Tokenizer
    from team_tpu_torch.bridge import tree_to
    from team_tpu_torch.ops import int8_matmul as im

    cfg = CLIPConfig.vit_b16()
    tokens = torch.from_numpy(Tokenizer(require_bpe=False)(prompts)).to(dev)
    p32 = tree_to(params, dev)
    bf16 = encode_text(cast_frozen_params(params, torch.bfloat16, dev), tokens, cfg,
                       compute_dtype=torch.bfloat16)
    dyn = quant.quantize_text_tower(p32)
    static = quant.quantize_text_tower_for_prompts(p32, tokens, cfg, heads=cfg.text.heads)
    plain = {**_plain_int8_fns(), **_plain_tier_fns()}
    out = {}
    for route, qt in (("xla", dyn), ("hybrid", dyn), ("pallas", dyn), ("static3d_qi", static)):
        im.reset_launch_counts()
        got = quant.encode_text_int8(qt, tokens, cfg, gemm_impl=route)
        launches = {name: getattr(im, name).launches for name in TIER_KERNELS}
        want = {name: cfg.text.layers * n for name, n in TIER_PER_BLOCK.get(route, {}).items()}
        if want:
            checked = _tier_kernels_on_tower_inputs(
                lambda: quant.encode_text_int8(qt, tokens, cfg, gemm_impl=route), f"text {route}")
            if not torch.equal(checked, got):
                raise AssertionError(f"the int8 text tower on {route} is not deterministic")
        ref = _swapped(plain, lambda: quant.encode_text_int8(qt, tokens, cfg, gemm_impl=route))
        cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1).min().item()
        cos_bf16 = torch.nn.functional.cosine_similarity(got, bf16, dim=-1).min().item()
        # static3d_qi's layer norm to int8 (ln_quant_folded) sums in another
        # order than its plain version, as ln_quantize does on the dynamic
        # tiers: against every plain version it takes their limit, against
        # its attention kernels' alone (the epilogue kernels on both sides)
        # the earlier one
        limit = 0.9995 if want or route == "static3d_qi" else 0.9999
        if route == "static3d_qi":
            attn = _swapped({**_plain_int8_fns(epilogues=False), **_plain_tier_fns()},
                            lambda: quant.encode_text_int8(qt, tokens, cfg, gemm_impl=route))
            cos_attn = torch.nn.functional.cosine_similarity(got, attn, dim=-1).min().item()
            print(f"  int8 text tower on {route} vs the plain versions of its attention kernels "
                  f"alone: min cosine {cos_attn:.7f} (limit 0.9999)")
            if cos_attn < 0.9999:
                raise AssertionError(f"the int8 text tower on {route} disagrees with the plain "
                                     "versions of its attention kernels")
        if want:
            ln_plain = _swapped({"ln_quantize": plain["ln_quantize"]},
                                lambda: quant.encode_text_int8(qt, tokens, cfg, gemm_impl=route))
            print(f"    text {route} with only ln_quantize's plain version in place: min cosine "
                  f"{torch.nn.functional.cosine_similarity(ln_plain, ref, dim=-1).min().item():.7f} "
                  "against the plain versions")
        print(f"  int8 text tower on {route} ({len(prompts)} class prompts, "
              f"{'prompt-set' if route == 'static3d_qi' else 'dynamic'} payload): vs the plain "
              f"versions min cosine {cos:.7f} (limit {limit}), vs the bf16 text tower "
              f"{cos_bf16:.7f} (limit 0.99); launches {launches}")
        if got.shape != bf16.shape or not bool(torch.isfinite(got).all()) or cos < limit \
                or cos_bf16 < 0.99 or (want and launches != want):
            raise AssertionError(f"the int8 text tower on {route} disagrees or missed a kernel")
        out[route] = {"cos_plain": cos, "cos_bf16": cos_bf16}
    return out


def _check_int8_config(ms, name, route, cache, per_encode, images, bf16_img, runtimes,
                       served_launches) -> dict:
    """One int8 configuration of phase 6 (its knobs set by the caller): load
    the payload from ``cache``, hold every int8 kernel call against its plain
    version on the tower's inputs (counting the q3i kernels' launches in that
    encode against ``per_encode``), the features against the same route with
    the plain versions and against the bf16 tower; returns its encode rate."""
    import torch

    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime

    cfg = smoke_config("simplecil", "bfloat16", "", encoder_quant="int8_static",
                       extras={"int8_cache_dir": cache, "int8_gemm_impl": route})
    rt = runtimes[name] = BackboneRuntime(cfg)
    img = rt.encode_image(rt.to_device(images))
    if not rt.int8_committed or rt.gate_cosine is not None:
        raise AssertionError(f"the int8 runtime ({name}) did not load the main path's "
                             "validated payload")
    ms.reset_launch_counts()
    checked = _int8_kernels_on_tower_inputs(rt, images, name)
    if per_encode is not None:
        got = {c: getattr(ms, c).launches for c in Q3I_COUNTERS}
        want = dict.fromkeys(Q3I_COUNTERS, 0)
        want.update(per_encode(rt.clip_cfg.vision.layers))
        served_launches[name] = got
        print(f"    {name}: q3i kernel launches in one encode {got} (want {want})")
        if got != want:
            raise AssertionError(f"{name}: launches {got} in one encode, want {want}")
    # against every kernel's plain version: the static3d routes' layer norm to
    # int8 (ln_quant_folded), the other routes' producers and int8-I/O kernels
    # flip an int8 step on about one output in 1e6 (checked just above on the
    # tower's own inputs), and a flipped step is requantized through every
    # later block, so the features are held to cosine >= 0.9999 and their
    # largest element difference to 5e-2 rms; static3d_qi against the plain
    # versions of its attention kernels alone (the epilogue kernels on both
    # sides), where no step flips, keeps its earlier bound, 5e-3 rms
    checks = [("its kernels", _plain_int8_fns(), 5e-2)]
    if name == "static3d_qi":
        checks.append(("its attention kernels", _plain_int8_fns(epilogues=False), 5e-3))
    for label, fns, max_rel in checks:
        plain = _encode_with(rt, images, fns)
        cos = torch.nn.functional.cosine_similarity(img, plain, dim=-1).min().item()
        err, rms = (img - plain).abs().max().item(), plain.pow(2).mean().sqrt().item()
        print(f"  int8 {name} image features (payload loaded from the cache) vs the same route "
              f"with the plain versions of {label}: min cosine {cos:.7f} (limit 0.9999), max abs "
              f"diff {err:.3e} (limit {max_rel * rms:.3e} = {max_rel:g} rms)")
        if img.shape != bf16_img.shape or not bool(torch.isfinite(img).all()) or cos < 0.9999 \
                or err > max_rel * rms or not torch.equal(checked, img):
            raise AssertionError(f"int8 {name} features through the kernels disagree with the "
                                 f"plain versions of {label}")
    cos_bf16 = torch.nn.functional.cosine_similarity(img, bf16_img, dim=-1).min().item()
    print(f"  int8 {name} vs bf16 tower on these test images (other colours than the "
          f"calibration batch): min cosine {cos_bf16:.7f}")
    key = "int8_static" if name == "static3d_qi" else f"int8_static_{name}"
    rate = _encode_rate(rt, images)
    print(f"  encode int8_static ({name}): {rate:.1f} img/s (B={EVAL_B}, 224x224 uint8 "
          f"in, ViT-B/16 image tower)")
    return {key: rate}


@contextlib.contextmanager
def plain_fused_kernels():
    """The towers' fused and pre-split kernels replaced by their plain
    versions (same card), under the names the towers call them by."""
    from team_tpu_torch.backbone import clip
    from team_tpu_torch.ops import attention
    from team_tpu_torch.ops import mha_short as ms

    swaps = [(clip, "fused_attn_block", ms.attn_block_reference),
             (clip, "fused_mha_packed_proj", ms.mha_packed_proj_reference),
             (attention, "fused_mha_short", ms.mha_short_reference)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _fused_route_features(params, images, prompts, rates: dict) -> int:
    """Features of the fused routes (both towers) and of the image tower on
    mha_short, each against the same tower through the plain versions of its
    kernels, to the limits of the packed route; their encode rates. Returns
    the pre-split kernel's launches in the checked encodes (counted from 0
    just before each, layers per encode)."""
    import torch

    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime
    from team_tpu_torch.ops import mha_short as ms

    short_launches = 0
    for dtype, min_cos in (("float32", 0.99999), ("bfloat16", 0.99)):
        for route in (*FUSED_ROUTES, "mha_short"):
            rt = BackboneRuntime(smoke_config("simplecil", dtype, "", attention_impl=route),
                                 params=params)
            batch = rt.to_device(images)
            ms.reset_launch_counts()
            got = {"image": rt.encode_image(batch)}
            launches = ms.fused_mha_short.launches
            if route == "mha_short":
                if launches != rt.clip_cfg.vision.layers:
                    raise AssertionError(f"mha_short: {launches} launches for one image encode")
                short_launches += launches
            else:  # the pre-split kernel is non-causal: the image tower only
                got["text"] = rt.encode_texts(prompts, cache=False)
            with plain_fused_kernels():
                want = {"image": rt.encode_image(batch)}
                if "text" in got:
                    want["text"] = rt.encode_texts(prompts, cache=False)
            for name, a in got.items():
                b = want[name]
                if a.shape != (len(b), rt.out_dim) or not bool(torch.isfinite(a).all()):
                    raise AssertionError(f"{route} {dtype} {name} features: shape "
                                         f"{tuple(a.shape)} or not finite")
                cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
                err = (a - b).abs().max().item()
                print(f"  {dtype} {name} features on {route} through its kernels vs its plain "
                      f"versions: min cosine {cos:.7f} (limit {min_cos}), max abs diff {err:.3e}")
                if cos < min_cos:
                    raise AssertionError(f"{route} {dtype} {name} features disagree with the "
                                         "plain versions")
            key = f"{dtype}_{route}"
            rates[key] = _encode_rate(rt, images)
            print(f"  encode {dtype} on {route}: {rates[key]:.1f} img/s (B={EVAL_B}, 224x224 "
                  "uint8 in, ViT-B/16 image tower)")
    return short_launches


STATIC_EPILOGUES = ("static_requant", "static_residual", "ln_quant_folded")


def _plain_int8_fns(epilogues: bool = True) -> dict:
    """The plain versions of every kernel the int8 routes call, by the name
    ``quant`` calls them under (with no tensor-parallel layout registered,
    ``fused_mha_packed_q3i_tp`` runs the whole-head kernel); without
    ``epilogues``, the static epilogue kernels stay in place."""
    from team_tpu_torch.ops import int8_matmul as im
    from team_tpu_torch.ops import mha_short as ms

    fns = {
        "fused_mha_packed_q3i_tp": ms.mha_packed_q3i_plain,
        "fused_mha_packed_q3i_cls": ms.mha_packed_q3i_cls_plain,
        "fused_mha_packed_q3i_cls_split": ms.mha_packed_q3i_cls_split_plain,
        "fused_mha_packed_q3i_sb": ms.mha_packed_q3i_sb_reference,
        "fused_mha_packed_q": lambda qkv, deq, oinv, h, *, seq, causal=False, kv_len=None:
            ms.mha_packed_q_reference(qkv.reshape(-1, seq, qkv.shape[-1]), deq, oinv, h, causal,
                                      kv_len).reshape(qkv.shape[0], -1),
        "fused_mha_packed_q3": lambda qkv, deq, oinv, h, *, causal=False, kv_len=None:
            ms.mha_packed_q_reference(qkv, deq, oinv, h, causal, kv_len, bf16_deq=True),
        "attention_core": lambda qkv, heads, *, causal, kv_len, impl:
            ms.mha_packed_reference(qkv, heads, causal, kv_len),
        "ln_quantize_static": im.ln_quantize_static_reference,
        "row_quant_static": im.row_quant_static_reference,
        "static_requant": im.static_requant_reference,
        "static_residual": im.static_residual_reference,
        "ln_quant_folded": im.ln_quant_folded_reference,
    }
    return fns if epilogues else {k: f for k, f in fns.items() if k not in STATIC_EPILOGUES}


def _encode_with(rt, images, fns: dict):
    """The int8 tower's features with ``fns`` in place of the functions of
    those names in ``quant`` (same payload, same card)."""
    return _swapped(fns, lambda: rt.encode_image(rt.to_device(images)))


def _int8_kernels_on_tower_inputs(rt, images, route: str):
    """Encode through the kernels and hold every int8 kernel call against its
    plain version on the same inputs, the tower's own activations: at most
    one int8 step, on under INT8_MAX_FRAC of the outputs of each kernel; the
    static epilogues to the limits of compare_static_epilogues (bit for bit
    without a GELU, the bf16 ``static_residual`` compared by its bits).
    Returns the features."""
    import torch

    from team_tpu_torch.backbone import quant

    plain = _plain_int8_fns()
    stats = {}
    share = dict.fromkeys(STATIC_EPILOGUES, EPILOGUE_MAX_FRAC)

    def checked(name, kernel):
        def call(*args, **kwargs):
            out = kernel(*args, **kwargs)
            ref = plain[name](*args, **kwargs)
            if out.dtype == torch.bfloat16:  # steps of the bf16 bit pattern
                diff = (out.view(torch.int16).int() - ref.view(torch.int16).int()).abs()
            else:
                diff = (out.int() - ref.int()).abs()
            if name == "static_residual" or (name == "static_requant"
                                             and kwargs.get("activation") is None):
                limit = 0
            elif kwargs.get("pv_int8"):  # the int8 PV's limit from this call's scales
                limit = pv_int8_limit(args[1], args[3])
            else:
                limit = 1
            key = (name, kwargs.get("activation") if name == "static_requant" else None)
            worst, n_diff, n, lim = stats.get(key, (0, 0, 0, limit))
            stats[key] = (max(worst, int(diff.max().item())), n_diff + int((diff > 0).sum()),
                          n + diff.numel(), min(lim, limit))
            return out
        return call

    names = [n for n in plain if n != "attention_core"]  # the int8-output kernels
    feats = _encode_with(rt, images, {n: checked(n, getattr(quant, n)) for n in names})
    for (name, act), (worst, n_diff, n, limit) in stats.items():
        frac = share.get(name, INT8_MAX_FRAC)
        unit = "bf16 steps" if name == "static_residual" else "int8 steps"
        label = f"{name} (activation {act})" if name == "static_requant" else name
        print(f"    {route}, {label} on the tower's own inputs: max |diff| {worst} {unit}, "
              f"{100 * n_diff / n:.5f} % of {n} outputs differ (limits {limit}, "
              f"{100 * frac:g} %)")
        if worst > limit or n_diff >= frac * n:
            raise AssertionError(f"{route}: {name} disagrees with its plain version on the "
                                 "tower's inputs")
    return feats


def _kernel_group(name: str) -> str:
    if "gemm_kernel" in name or "gelu_quant_kernel" in name or "blockscale_kernel" in name:
        return "int8 GEMM kernels (int8_linear, gelu_quant, blockscale)"
    if "ln_qkv_kernel" in name or "mha_packed_proj_kernel" in name:
        return "fused attention kernels (layer norm + qkv GEMM; attention + out-projection)"
    if ("q3i_kernel" in name or "q3i_cls_kernel" in name or "mha_packed_kernel" in name
            or "flash_kernel" in name or "mha_q_kernel" in name):
        return "attention kernels"
    if ("requant_static_kernel" in name or "residual_static_kernel" in name
            or "ln_quant_folded_kernel" in name):
        return "static epilogues (requant, residual, ln_quant_folded)"
    if "quant_static_kernel" in name or "ln_quant_kernel" in name:
        return "quantize producers (ln_quantize, ln_quantize_static, row_quant_static)"
    low = name.lower()
    if "gemm" in low or "nvjet" in low or "cutlass" in low or "xmma" in low:
        return "GEMMs"
    return "elementwise and other"


def profile_encodes(int8_runtimes, pallas_encode, dev) -> None:
    """torch.profiler device time of one B=128 encode, by kernel: int8 on
    static3d_qi, static_qa and static3d_qis, the int8 pallas tier (library
    API, dynamic payload), bf16 through the packed kernel, bf16 through the
    flash kernel, bf16 on attn_block and on mha_packed_proj."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime

    rt_bf16 = BackboneRuntime(smoke_config("simplecil", "bfloat16", ""))
    bf16_routes = {route: BackboneRuntime(smoke_config("simplecil", "bfloat16", "",
                                                       attention_impl=route))
                   for route in ("pallas", *FUSED_ROUTES)}
    size = rt_bf16.clip_cfg.vision.image_size
    u8 = np.random.default_rng(0).integers(0, 256, (EVAL_B, size, size, 3), dtype=np.uint8)
    runs = [(name, rt.encode_image, rt.to_device(u8)) for name, rt in (
        ("int8_static", int8_runtimes["static3d_qi"]),
        ("int8_static static_qa", int8_runtimes["static_qa"]),
        ("int8_static static3d_qis", int8_runtimes["static3d_qis"]))]
    runs.append(("int8 pallas tier (dynamic payload)", pallas_encode,
                 torch.from_numpy(u8).to(dev)))
    runs += [(name, rt.encode_image, rt.to_device(u8)) for name, rt in (
        ("bfloat16", rt_bf16), ("bfloat16 through the flash kernel", bf16_routes["pallas"]),
        *((f"bfloat16 on {r}", bf16_routes[r]) for r in FUSED_ROUTES))]
    for name, encode, batch in runs:
        encode(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            encode(batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        total = sum(e.self_device_time_total for e in kernels) / 1e3
        print(f"  {name}: one B={EVAL_B} encode, wall {1e3 * wall:.2f} ms, device kernel time "
              f"{total:.2f} ms")
        if not kernels:
            print("    (the trace holds no device time)")
            continue
        groups = defaultdict(float)
        for e in kernels:
            groups[_kernel_group(e.key)] += e.self_device_time_total / 1e3
        for group, ms_ in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"    {group}: {ms_:.3f} ms ({100 * ms_ / total:.1f} %)")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"    {e.self_device_time_total / 1e3:8.3f} ms  {e.count:4d}x  {e.key[:110]}")



# ---------------------------------------------------------------------------
# the tensor-parallel head split (kernels #2 and #11) and the parallel paths
# ---------------------------------------------------------------------------

TP_NM = (2, 4)  # model ranks the head-split kernels are held at (12 and 8 heads split)
# the modes of #7 that #11 is held in at the vision shape: name -> (knobs, arguments,
# whether the static softmax's constant is given)
TP_Q3I_MODES = {"static": ({}, {}, True), "rowmax": ({}, {}, False),
                **{m: (env, kw, True) for m, (env, kw) in Q3I_MODES.items()}}
PARALLEL_WORLD = 2  # ranks the parallel phase spawns on the one card (gloo)


class TPLayout:
    """A tensor-parallel layout with this process at ``model_rank`` of
    ``n_model``, as ``set_tp_mesh`` takes it (the kernel checks need no
    process group: each rank's share is computed in turn)."""

    def __init__(self, rank: int, nm: int):
        self.model_rank, self.n_model = rank, nm


def tp_ranks(ms, nm: int, fn) -> list:
    """``fn()`` under each of the ``nm`` model ranks' layouts, in rank order."""
    outs = []
    try:
        for r in range(nm):
            ms.set_tp_mesh(TPLayout(r, nm))
            outs.append(fn(r))
    finally:
        ms.set_tp_mesh(None)
    return outs


def compare_tp(ms, dev) -> dict:
    """The head-split kernels at the towers' shapes for nm in TP_NM: each
    rank's output against its plain version (the packed tolerances; one int8
    step, the int8 PV's wider limit), and the ranks side by side against the
    whole-head kernels #1 and #7 bit for bit (tolerance 0)."""
    import torch

    worst = {"fused_mha_packed_tp": 0.0, "fused_mha_packed_q3i_tp": 0}
    for tower, (b, s, h, causal) in MAIN_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn((b, s, 3 * h * 64), generator=torch.Generator(device=dev).manual_seed(8),
                              device=dev).to(dtype)
            whole = ms.fused_mha_packed(qkv, h, causal=causal)
            for nm in TP_NM:
                outs = tp_ranks(ms, nm, lambda r: ms.fused_mha_packed_tp(qkv, h, causal=causal))
                refs = [ms.mha_packed_tp_plain(qkv, h, r, nm, causal=causal) for r in range(nm)]
                torch_sync()
                err = max((o.float() - p.float()).abs().max().item() for o, p in zip(outs, refs))
                equal = torch.equal(torch.cat(outs, dim=-1), whole)
                tol = TOL[str(dtype)]
                print(f"  mha_packed_tp {tower} B={b} S={s} H={h} nm={nm} {dtype}: ranks vs plain "
                      f"max_abs_err {err:.3e} (tol {tol:g}); side by side == fused_mha_packed "
                      f"bit for bit {equal}")
                if not math.isfinite(err) or err > tol or not equal:
                    raise AssertionError("fused_mha_packed_tp disagrees with its plain version or "
                                         "with the whole-head kernel")
                worst["fused_mha_packed_tp"] = max(worst["fused_mha_packed_tp"], err)
    cases = [(*MAIN_SHAPES["vision"], mode) for mode in TP_Q3I_MODES] + \
            [(*MAIN_SHAPES["text"], "rowmax")]
    for b, s, h, causal, mode in cases:
        env, kw, static = TP_Q3I_MODES[mode]
        qkv, deq, qks, oinv, m2 = q3i_inputs(b, s, h, dev, seed=9)
        call = dict(causal=causal, qk_m2=m2 if static else None, **kw)
        limit = pv_int8_limit(deq, oinv) if kw.get("pv_int8") else 1
        with knobs(env):
            whole = ms.fused_mha_packed_q3i(qkv, deq, qks, oinv, h, **call)
            for nm in TP_NM:
                outs = tp_ranks(ms, nm, lambda r: ms.fused_mha_packed_q3i_tp(qkv, deq, qks, oinv, h,
                                                                               **call))
                name = f"q3i_tp[{mode}] B={b} S={s} H={h} causal={causal} nm={nm}"
                for r, out in enumerate(outs):
                    ref = ms.mha_packed_q3i_tp_plain(qkv, deq, qks, oinv, h, r, nm, **call)
                    torch_sync()
                    worst["fused_mha_packed_q3i_tp"] = max(
                        worst["fused_mha_packed_q3i_tp"],
                        _int8_disagreement(f"{name} rank {r} vs plain", out, ref, limit))
                equal = torch.equal(torch.cat(outs, dim=-1), whole)
                print(f"  {name}: side by side == fused_mha_packed_q3i bit for bit {equal} "
                      "(tolerance 0)")
                if not equal:
                    raise AssertionError("fused_mha_packed_q3i_tp differs from the whole-head kernel")
    return worst


def time_tp(ms, dev) -> dict:
    """Card time of one rank's launch of each head-split kernel (rank 0; the
    ranks do equal work) at the vision shape for nm in TP_NM and the text
    shape at nm 2, beside its plain version, its bound (the rank's third of
    qkv read, its D/nm columns written) and, for #2,
    scaled_dot_product_attention on the rank's head views of the full qkv
    (#11 has no one-call counterpart)."""
    import torch

    times = {}
    for tower, (b, s, h, causal) in MAIN_SHAPES.items():
        qkv = torch.randn((b, s, 3 * h * 64), generator=torch.Generator(device=dev).manual_seed(10),
                          device=dev).to(torch.bfloat16)
        for nm in TP_NM if tower == "vision" else TP_NM[:1]:
            hm = h // nm
            ms.set_tp_mesh(TPLayout(0, nm))
            try:
                kernel = lambda: ms.fused_mha_packed_tp(qkv, h, causal=causal)  # noqa: E731
                plain = lambda: ms.mha_packed_tp_plain(qkv, h, 0, nm, causal=causal)  # noqa: E731
                p1, k1, k2, p2 = _time_ms(plain), _time_ms(kernel), _time_ms(kernel), _time_ms(plain)
            finally:
                ms.set_tp_mesh(None)
            q, k, v = (t.reshape(b, s, h, 64)[:, :, :hm].transpose(1, 2)
                       for t in qkv.split(h * 64, dim=-1))
            lib = sdpa_ms(q, k, v, causal)
            key = f"tp {tower} nm={nm}"
            times[key] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib,
                          **bound(qkv.numel() * 2 // nm + b * s * hm * 64 * 2,
                                  {"bf16": attention_ops(b, hm, s, 64, causal)})}
            print(f"  mha_packed_tp {tower} B={b} S={s} H={h} nm={nm} causal={causal} bf16, one "
                  f"rank: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
                  f"scaled_dot_product_attention on its head views {lib:.4f} ms, bound "
                  f"{times[key]['bound_ms']:.4f} ms ({times[key]['bound_by']})")
    b, s, h, _ = MAIN_SHAPES["vision"]
    qkv, deq, qks, oinv, m2 = q3i_inputs(b, s, h, dev, seed=11)
    args = (qkv, deq, qks, oinv, h)
    for nm in TP_NM:
        hm, dm = h // nm, h * 64 // nm
        ms.set_tp_mesh(TPLayout(0, nm))
        try:
            kernel = lambda: ms.fused_mha_packed_q3i_tp(*args, qk_m2=m2)  # noqa: E731
            plain = lambda: ms.mha_packed_q3i_tp_plain(*args, 0, nm, qk_m2=m2)  # noqa: E731
            p1, k1, k2, p2 = _time_ms(plain), _time_ms(kernel), _time_ms(kernel), _time_ms(plain)
        finally:
            ms.set_tp_mesh(None)
        ops = attention_ops(b, hm, s, 64, False) // 2
        bnd = bound(qkv.numel() // nm + b * s * dm + 4 * (3 * dm + 2 * hm + dm),
                    {"int8": ops, "bf16": ops})
        key = f"q3i_tp vision nm={nm}"
        times[key] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": None, **bnd}
        print(f"  q3i_tp vision B={b} S={s} H={h} nm={nm} int8, one rank: kernel {k1:.4f}/"
              f"{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}); no single PyTorch call computes it")
    return times


def _proof_config(log_dir: str, **kw):
    return smoke_config("proof", "bfloat16", log_dir, batch_size=FLAGSHIP_BATCH, tuned_epoch=2,
                        **kw)


def _train_recording(cfg, grads_path: str = "") -> dict:
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

    t0 = time.perf_counter()
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
    return {"curves": [float(a) for a in res["cnn_top1"]], "stats": losses,
            "wall_s": time.perf_counter() - t0}


GRAD_STEPS = 2  # steps whose gradients the data-parallel check holds
GRAD_LIMIT = 1e-3  # of each leaf's largest gradient; a sum off by the world size is 0.5


def _grads_agree(name: str, want_path: str, got_path: str) -> float:
    """The gradients two runs pickled (:func:`_train_recording`) agree leaf
    by leaf within GRAD_LIMIT of the leaf's largest. AdamW's update does not
    see a gradient scaled by a constant, so the curves and losses alone would
    pass a step off by the world size; the gradients do not."""
    import pickle

    import numpy as np

    with open(want_path, "rb") as f:
        want = pickle.load(f)
    with open(got_path, "rb") as f:
        got = pickle.load(f)
    if len(want) != GRAD_STEPS or len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} and {len(want)} steps of gradients recorded")
    worst, ratio = 0.0, []
    for gw, gg in zip(want, got):
        if [a is None for a in gw] != [b is None for b in gg]:
            raise AssertionError(f"{name}: the leaves with a gradient differ")
        for a, b in zip(gw, gg):
            if a is not None:
                scale = max(float(np.abs(a).max()), 1e-12)
                worst = max(worst, float(np.abs(a - b).max()) / scale)
        ratio.append(sum(float(np.abs(b).sum()) for b in gg if b is not None)
                     / max(sum(float(np.abs(a).sum()) for a in gw if a is not None), 1e-30))
    print(f"  {name}: the first {GRAD_STEPS} steps' gradients within {worst:.3e} of each leaf's "
          f"largest (limit {GRAD_LIMIT}); summed |g| ratio {ratio}")
    if not worst <= GRAD_LIMIT:
        raise AssertionError(f"{name}: gradients differ by {worst} of their largest")
    return worst


def _agree(name: str, want: dict, got: dict) -> None:
    """Curves equal, and each epoch's loss components within 1e-3 relative
    (the bound of tests/test_multihost.py)."""
    worst = 0.0
    if got["curves"] != want["curves"] or len(got["stats"]) != len(want["stats"]):
        raise AssertionError(f"{name}: curves {got['curves']} vs {want['curves']}")
    for (t0, e0, d0), (t1, e1, d1) in zip(want["stats"], got["stats"]):
        if (t0, e0) != (t1, e1) or d0["n"] != d1["n"]:
            raise AssertionError(f"{name}: epochs differ")
        for k in ("total", "ce", "clip", "unicl"):
            rel = abs(d0[k] - d1[k]) / max(1.0, abs(d0[k]))
            worst = max(worst, rel)
    print(f"  {name}: curves {got['curves']} equal; loss components within {worst:.3e} relative "
          "(limit 1e-3)")
    if worst > 1e-3:
        raise AssertionError(f"{name}: loss components differ by {worst}")


def run_parallel_paths(ms, log_dir: str) -> dict:
    """Phase 5's parallel paths at full ViT-B/16 width. (a) A world of one
    rank over NCCL: PROOF with mesh_shape [1] and [1, 1] gives the curves of
    the run without a mesh. (b) PARALLEL_WORLD ranks on the one card over
    gloo, spawned from this script (parallel_worker): PROOF data parallel on
    mesh_shape [2], which must give the single-process curves; the bf16
    image tower under a [1, 2] layout on mha_packed_tp; the int8
    static3d_qi tower under it, whose q3i attention runs through #11."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from team_tpu_torch.parallel import collectives
    from team_tpu_torch.parallel.mesh import maybe_init_distributed

    single_grads = os.path.join(log_dir, "proof_nomesh_grads.pkl")
    single = _train_recording(_proof_config(os.path.join(log_dir, "proof_nomesh")), single_grads)
    print(f"  proof (bf16, default route, batch {FLAGSHIP_BATCH}) without a mesh: curves "
          f"{single['curves']}, {single['wall_s']:.2f} s")
    init = os.path.join(log_dir, "rdzv_world1")
    maybe_init_distributed([0], init_method=f"file://{init}", world_size=1, rank=0)
    print(f"  joined: {collectives.describe()}")
    if dist.get_backend() != "nccl":
        raise AssertionError("a world of one rank on its own card must run over NCCL")
    try:
        for shape in ([1], [1, 1]):
            got = _train_recording(_proof_config(os.path.join(log_dir, f"proof_mesh{len(shape)}"),
                                                 mesh_shape=shape,
                                                 mesh_axis_names=["data", "model"]))
            _agree(f"proof mesh_shape {shape} (world 1, NCCL) vs no mesh", single, got)
    finally:
        dist.destroy_process_group()

    out_dir = os.path.join(log_dir, "parallel")
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-worker",
                               str(r), str(PARALLEL_WORLD), os.path.join(out_dir, "rdzv"), out_dir],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(PARALLEL_WORLD)]
    try:
        outs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            if line.startswith("  "):
                print(f"  rank {r}:{line}")
        if p.returncode != 0:
            raise AssertionError(f"parallel rank {r} failed (exit {p.returncode}):\n{out[-6000:]}")
    ranks = []
    for r in range(PARALLEL_WORLD):
        with open(os.path.join(out_dir, f"rank{r}.json"), encoding="utf-8") as f:
            ranks.append(json.load(f))
    print(f"  {PARALLEL_WORLD} ranks on one card ({ranks[0]['describe']}): {wall:.2f} s with start-up")
    grad_err = 0.0
    for r, res in enumerate(ranks):
        _agree(f"rank {r}: proof mesh_shape [{PARALLEL_WORLD}] (gloo) vs the single process",
               single, res["dp"])
        grad_err = max(grad_err, _grads_agree(
            f"rank {r}: proof mesh_shape [{PARALLEL_WORLD}] (gloo) vs the single process",
            single_grads, os.path.join(out_dir, f"dp_grads_rank{r}.pkl")))
    # the TP image tower against the single-device tower on the same weights and images
    rt_feats = [np.load(os.path.join(out_dir, f"tp_image_rank{r}.npy")) for r in range(PARALLEL_WORLD)]
    if not np.array_equal(rt_feats[0], rt_feats[1]):
        raise AssertionError("the ranks' tensor-parallel features differ")
    ref = _single_device_features(os.path.join(out_dir, "tp_images.npy"))
    a, b = torch.from_numpy(rt_feats[0]).double(), torch.from_numpy(ref).double()
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
    print(f"  bf16 image tower on mha_packed_tp under [1, {PARALLEL_WORLD}] vs one device: min "
          f"cosine {cos:.7f} over {len(a)} images (limit {TP_MIN_COSINE}), max abs diff "
          f"{(a - b).abs().max().item():.3e}")
    if not cos >= TP_MIN_COSINE:
        raise AssertionError("tensor-parallel features disagree with the single-device tower")
    gates = [(res["int8"]["gate_cosine"], res["int8"]["committed"]) for res in ranks]
    print(f"  int8 static3d_qi under [1, {PARALLEL_WORLD}]: gate (min cosine, committed) per rank "
          f"{gates}")
    if len(set(gates)) != 1 or not gates[0][1]:
        raise AssertionError("the ranks' int8 gates differ or did not commit")
    launches = {"fused_mha_packed_tp": [res["launches"]["fused_mha_packed_tp"] for res in ranks],
                "fused_mha_packed_q3i_tp": [res["launches"]["fused_mha_packed_q3i_tp"]
                                            for res in ranks]}
    print(f"  head-split launches per rank: {launches}")
    if not all(n > 0 for v in launches.values() for n in v):
        raise AssertionError("a rank's parallel path launched no head-split kernel")
    return {"launches": {k: sum(v) for k, v in launches.items()}, "per_rank": launches,
            "tp_cosine": cos, "gate": gates[0], "wall_s": wall, "dp_grad_err": grad_err,
            "dp_wall_s": [res["dp"]["wall_s"] for res in ranks]}


TP_MIN_COSINE = 0.999  # bf16 row-parallel sums run in another order than one device's GEMM
TP_IMAGES = 128  # the learners' eval batch


def _tp_weights_and_images():
    """The full-width towers' random weights (seed 0) and a B=128 batch of
    the smoke dataset's test images (uint8, 224x224), the same in every process."""
    import numpy as np
    import torch

    from team_tpu_torch.backbone.clip import CLIPConfig, init_clip_params
    from team_tpu_torch.data import DataManager

    dm = DataManager("synthetic_insects", True, 1, 2, 2, **DATASET)
    images = np.stack(dm.get_dataset(np.arange(4), source="test", mode="test").images[:8])
    return init_clip_params(torch.Generator().manual_seed(0), CLIPConfig.vit_b16()), \
        _eval_batch(images)


def _single_device_features(images_path: str):
    import numpy as np

    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime

    params, _ = _tp_weights_and_images()
    rt = BackboneRuntime(smoke_config("simplecil", "bfloat16", ""), params=params)
    return rt.encode_image(rt.to_device(np.load(images_path))).cpu().numpy()


def parallel_worker(rank: int, world: int, init: str, out_dir: str) -> int:
    """One rank of phase 5's parallel paths, run by run_parallel_paths:
    ``world`` ranks share card 0 (device list [0, 0]), so the layout gives
    gloo and host staging. Writes rank<r>.json (and the TP features) to
    ``out_dir``; the parent checks them."""
    import numpy as np
    import torch

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    from team_tpu_torch.backbone.clip import CLIPConfig, cast_frozen_params, encode_image
    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime
    from team_tpu_torch.ops import mha_short as ms
    from team_tpu_torch.ops.preprocess import preprocess_batch
    from team_tpu_torch.parallel import collectives
    from team_tpu_torch.parallel.mesh import make_mesh, maybe_init_distributed, shard_clip_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    devices = [0] * world
    maybe_init_distributed(devices, init_method=f"file://{init}", world_size=world, rank=rank)
    ms.build()
    res = {"describe": collectives.describe()}
    # data parallel: PROOF over a [world] mesh through the trainer
    res["dp"] = _train_recording(_proof_config(os.path.join(out_dir, "proof_dp"),
                                               mesh_shape=[world], device=devices),
                                 os.path.join(out_dir, f"dp_grads_rank{rank}.pkl"))
    print(f"  proof mesh_shape [{world}]: curves {res['dp']['curves']}, "
          f"{res['dp']['wall_s']:.2f} s", flush=True)
    # tensor parallel: the bf16 image tower under a [1, world] layout, weights split
    mesh = make_mesh([1, world], ("data", "model"), device=devices)
    dev = mesh.device
    params, images = _tp_weights_and_images()
    if rank == 0:
        np.save(os.path.join(out_dir, "tp_images.npy"), images)
    clip_cfg = CLIPConfig.vit_b16()
    layers = clip_cfg.vision.layers
    split = shard_clip_params(cast_frozen_params(params, torch.bfloat16, dev), mesh)
    ms.reset_launch_counts()
    ms.set_tp_mesh(mesh)
    try:
        with torch.no_grad():
            x = preprocess_batch(torch.from_numpy(images).to(dev), clip_cfg.vision.image_size)
            t0 = time.perf_counter()
            feats = encode_image(split, x, clip_cfg, compute_dtype=torch.bfloat16,
                                 attn_impl="mha_packed_tp")
            torch.cuda.synchronize()
            tp_s = time.perf_counter() - t0
        launches_tp = ms.fused_mha_packed_tp.launches
        np.save(os.path.join(out_dir, f"tp_image_rank{rank}.npy"), feats.float().cpu().numpy())
        print(f"  bf16 image tower, B={len(images)}, on mha_packed_tp: {tp_s:.3f} s, "
              f"mha_packed_tp launches {launches_tp} (one a block)", flush=True)
        if launches_tp != layers:
            raise AssertionError(f"mha_packed_tp launches {launches_tp}, want one a block")
        # the int8 static3d_qi tower: calibrate, gate, then one committed encode
        qcfg = smoke_config("simplecil", "bfloat16", "", attention_impl="mha_packed_tp",
                            encoder_quant="int8_static", device=devices)
        qrt = BackboneRuntime(qcfg, params=params)
        batches = [images[i:i + FLAGSHIP_BATCH] for i in (0, FLAGSHIP_BATCH)]
        ms.reset_launch_counts()
        for batch in batches:
            qrt.encode_image(qrt.to_device(batch))
        q_feats = qrt.encode_image(qrt.to_device(images))
        torch.cuda.synchronize()
        launches_q = ms.fused_mha_packed_q3i_tp.launches
        launches_tp += ms.fused_mha_packed_tp.launches
    finally:
        ms.set_tp_mesh(None)
    # the same payload on one device (whole-head kernels, the CLS kernel last)
    whole = qrt.encode_image(qrt.to_device(images)).double()
    cos = torch.nn.functional.cosine_similarity(whole, q_feats.double(), dim=-1).min().item()
    same = bool(torch.equal(whole, q_feats.double()))
    print(f"  int8 static3d_qi on mha_packed_tp: gate {qrt.gate_cosine}, committed "
          f"{qrt.int8_committed}; q3i_tp launches {launches_q}; features vs one device's: min "
          f"cosine {cos:.7f} (limit 0.99999), bit for bit {same}", flush=True)
    if not qrt.int8_committed or launches_q != 2 * layers or not cos >= 0.99999:
        raise AssertionError("the int8 tower under tensor parallelism: gate, launches or features")
    res["int8"] = {"gate_cosine": qrt.gate_cosine, "committed": qrt.int8_committed,
                   "cos_one_device": cos, "bit_equal_one_device": same}
    res["launches"] = {"fused_mha_packed_tp": launches_tp, "fused_mha_packed_q3i_tp": launches_q}
    collectives.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w", encoding="utf-8") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# #4 fused_mha_short_v2, #29 the q3i decomposition variants,
# #26 normalize_uint8_kernel, their entry points, and the repairs of faults
# 3.2 (bicubic resize) and 3.8 (the open_clip loader, require_bpe)
# ---------------------------------------------------------------------------

V2_CASES = ((None,), (150,))  # kv_len at the vision shape: every key, and keys >= 150 masked
V2_STEPS = 2  # bf16 #3/#4 on the probe paths and #4 at the vision shape: bf16 steps of |ref|
VARIANT_OINV = {"script": (20.0, 60.0), "unclipped": (0.5, 2.0)}  # o_inv ranges the variants are held at
RESIZE_TOL = 1e-5  # the resize on the card against the CPU (float32 contractions in another order)
RESIZE_CASES = (((4, 32, 32, 3), "up 32->224"), ((4, 256, 320, 3), "down 256x320->224"))


def v2_inputs(b, h, s, dtype, dev, seed=0, dh=64):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((b, h, s, dh), generator=g, device=dev).to(dtype) for _ in range(3)]


def _bf16_step(x):
    """One bf16 step (unit in the last place) at each ``x >= 0``."""
    import torch

    _, expo = torch.frexp(x.clamp_min(2.0 ** -126))  # x = m 2^e, m in [0.5, 1)
    return torch.ldexp(torch.ones_like(x), expo - 8)


def _check_bf16_steps(name: str, out, ref) -> float:
    """max |out - ref| of a bfloat16 attention output ``[..., Dh]``; raises
    past V2_STEPS bf16 steps of |ref|, plus one step of the largest |ref| in
    its row, plus float32's 1e-5. The row's step covers a probability p_j
    rounded to bf16 on the other side of an edge (its f32 value one ulp
    apart, the exp or the sum in another order): that moves each output of
    the row by at most 2^-8 p_j |v_j|, which small outputs of a row of
    near-uniform p (the probes' inputs) do not cover by their own steps."""
    r = ref.float()
    err = (out.float() - r).abs()
    own = TOL["torch.float32"] + V2_STEPS * _bf16_step(r.abs())
    limit = own + _bf16_step(r.abs().amax(dim=-1, keepdim=True))
    worst = err.max().item()
    past_own = 100 * (err > own).float().mean().item()
    print(f"  {name} torch.bfloat16: max_abs_err={worst:.3e}, {past_own:.4f} % of outputs past "
          f"{V2_STEPS} steps of |ref|, worst at {(err / limit).max().item():.3f} of the limit "
          f"(tol {V2_STEPS} steps of |ref| + one step of the row's max |ref| + "
          f"{TOL['torch.float32']:g})")
    if out.shape != ref.shape or not math.isfinite(worst) or bool((err > limit).any()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return worst


def _check_one_step(name: str, out, other, magnitude, n_keys: int) -> int:
    """#4's bfloat16 output against another kernel's output of the same p:
    every output within one bf16 step (at the larger |value|) plus what two
    orders of the f32 sum of the n_keys terms p_j v_j / l may differ by, 2
    n_keys 2^-24 ``magnitude`` (sum_j p_j |v_j| / l: outputs that cancel to
    ~1e-6 out of terms ~0.8 move by more than their own step); returns, and
    prints, how many differ at all."""
    import torch

    a, b = out.float(), other.float()
    step = _bf16_step(torch.maximum(a.abs(), b.abs()))
    diff = (a - b).abs()
    n = int((diff > 0).sum().item())
    limit = step + 2 * n_keys * 2.0 ** -24 * magnitude.float()
    print(f"  {name}: {n} of {out.numel()} outputs differ, {int((diff > step).sum().item())} by "
          f"more than one bf16 step, the worst at {(diff / limit).max().item():.3f} of the limit "
          "(one step plus the f32 order bound)")
    if out.shape != other.shape or bool((diff > limit).any()):
        raise AssertionError(f"{name}: past one bf16 step plus the f32 order bound")
    return n


def _check_switch(switch: str, out, without, ref) -> None:
    """A switch of #4 (the deferred normalise, the bf16 exp) takes effect:
    the bf16 kernel's output with it differs from its output without it, and
    fewer of its outputs differ from the plain version of the switched
    arithmetic."""
    import torch

    differ = (out != ref).float().mean().item()
    differ_without = (without != ref).float().mean().item()
    print(f"  switch {switch}: {100 * differ:.4f} % of the outputs differ from its plain version "
          f"with it, {100 * differ_without:.4f} % without it")
    if torch.equal(out, without) or not differ < differ_without:
        raise AssertionError(f"the kernel's {switch} switch does not take effect")


def compare_v2(ms, dev) -> float:
    """#4 against its plain version at the vision shape, bf16 and f32, both
    exp dtypes, every key and kv_len < S (f32 within 1e-5; bf16 as
    :func:`_check_bf16_steps`); bf16 also against the CUDA-core kernel it
    replaced (:func:`_check_one_step`). On bf16 inputs each switch
    must show: the deferred normalise against #3 (the same kernel without
    it), the bf16 exp against the f32 exp."""
    import torch

    b, s, h, _ = MAIN_SHAPES["vision"]
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = v2_inputs(b, h, s, dtype, dev)
        for (kv_len,) in V2_CASES:
            outs = {}
            for exp_dtype in (torch.float32, torch.bfloat16):
                out = ms.fused_mha_short_v2(q, k, v, kv_len, exp_dtype=exp_dtype)
                ref = ms.mha_short_v2_reference(q, k, v, kv_len, exp_dtype)
                torch_sync()
                name = f"fused_mha_short_v2 B={b} H={h} S={s} kv_len={kv_len} exp {exp_dtype}"
                worst = max(worst, _check_bf16_steps(name, out, ref) if dtype == torch.bfloat16
                            else _check_close(name, out, ref, dtype))
                outs[exp_dtype] = out, ref
            if dtype == torch.bfloat16:
                for exp_dtype, (out, _) in outs.items():
                    core = ms.fused_mha_short_v2_cuda_core(q, k, v, kv_len, exp_dtype=exp_dtype)
                    magnitude = ms.mha_short_v2_reference(q, k, v.abs(), kv_len, exp_dtype)
                    torch_sync()
                    _check_one_step(f"fused_mha_short_v2 B={b} H={h} S={s} kv_len={kv_len} exp "
                                    f"{exp_dtype} against the CUDA-core kernel (p bit for bit, "
                                    "PV and l summed in another order)", out, core, magnitude,
                                    s if kv_len is None else kv_len)
                v1 = ms.fused_mha_short(q, k, v, kv_len)
                torch_sync()
                _check_switch(f"DEFER (kv_len={kv_len})", outs[torch.float32][0], v1,
                              outs[torch.float32][1])
                _check_switch(f"BF16_EXP (kv_len={kv_len})", outs[torch.bfloat16][0],
                              outs[torch.float32][0], outs[torch.bfloat16][1])
    return worst


def _variant_inputs(r4, dev, oinv_range):
    """The probe's inputs at the vision batch, o_inv drawn in ``oinv_range``."""
    import torch

    qkv, qks, qkm2, oinv = r4.make_inputs(MAIN_SHAPES["vision"][0], dev)
    g = torch.Generator(device=dev).manual_seed(3)
    lo, hi = oinv_range
    return qkv, qks, qkm2, torch.rand(oinv.shape, generator=g, device=dev) * (hi - lo) + lo


def _check_variant(ms, name: str, qkv, qks, qkm2, oinv, heads: int, variant: str) -> int:
    """One #29 variant against its plain version: copy bit for bit, the
    others at most one int8 step on under 1 % of the outputs, their float
    outputs before rounding checked finite first (so no comparison rests on
    converting inf or NaN to int8)."""
    import torch

    out = ms.fused_mha_q3i_variant(qkv, qks, qkm2, oinv, heads, variant)
    ref = ms.mha_q3i_variant_reference(qkv, qks, qkm2, oinv, heads, variant)
    torch_sync()
    if variant == "copy":
        if not torch.equal(out, ref):
            raise AssertionError(f"{name}: the copy differs from q")
        print(f"  {name}: bit for bit (tolerance 0)")
        return 0
    before = ms.mha_q3i_variant_float(qkv, qks, qkm2, oinv, heads, variant)
    if not bool(torch.isfinite(before).all()):
        raise AssertionError(f"{name}: the plain float output is not finite")
    saturated = (ref.abs() == 127).float().mean().item()
    return _int8_disagreement(f"{name} ({100 * saturated:.1f} % at +-127)", out, ref)


def compare_q3i_variants(ms, dev) -> dict:
    """Each #29 variant against its plain version (:func:`_check_variant`) on
    the probe's inputs at the vision batch, with the script's o_inv (20-60,
    where full saturates most outputs) and with o_inv 0.5-2 (most not
    clipped)."""
    from team_tpu_torch.scripts import r4_attn_decomp as r4

    worst = dict.fromkeys(ms.Q3I_VARIANTS, 0)
    for label, rng in VARIANT_OINV.items():
        qkv, qks, qkm2, oinv = _variant_inputs(r4, dev, rng)
        for variant in ms.Q3I_VARIANTS:
            name = f"q3i variant {variant} B={qkv.shape[0]} S={r4.S} H={r4.H} o_inv {label}"
            worst[variant] = max(worst[variant], _check_variant(ms, name, qkv, qks, qkm2, oinv,
                                                                r4.H, variant))
    return worst


def compare_probe_shapes(ms, dev) -> dict:
    """The kernels of the two probe paths at the probes' own shapes and
    inputs (B=256), against their plain versions. attn_shootout: each of its
    kernel implementations (MODE all and qpad128) on the inputs of its first
    two chained layers, the probe's first input and tanh of the kernel's
    output on it (v1 and v2 as :func:`_check_bf16_steps`).
    r4_attn_decomp: each variant on the probe's own inputs
    (:func:`_check_variant`), its first layer only: from the second layer
    on, full's inputs are mostly +-127 and its exp2 overflows to inf in the
    plain version too."""
    import torch

    from team_tpu_torch.scripts import attn_shootout as sh
    from team_tpu_torch.scripts import r4_attn_decomp as r4

    bf16 = torch.bfloat16
    plains = {  # attn_shootout's labels -> (kernel, plain version)
        "plain (xla_attention)": None,
        "mha_short v1": ("fused_mha_short", lambda x: ms.mha_short_reference(x, x, x, sh.S)),
        "mha_short v2 f32exp": ("fused_mha_short_v2",
                                lambda x: ms.mha_short_v2_reference(x, x, x, sh.S)),
        "mha_short v2 bf16exp": ("fused_mha_short_v2",
                                 lambda x: ms.mha_short_v2_reference(x, x, x, sh.S, bf16)),
        "v2 qpad=128 (deferred norm)": ("fused_mha_short_v2",
                                        lambda x: ms.mha_short_v2_reference(x, x, x, sh.S)),
        "v2 qpad=128 bf16exp": ("fused_mha_short_v2",
                                lambda x: ms.mha_short_v2_reference(x, x, x, sh.S, bf16)),
    }
    worst = {"fused_mha_short": 0.0, "fused_mha_short_v2": 0.0}
    x0 = sh.make_inputs(sh.B, dev, n=1)[0]
    for mode in ("all", "qpad128"):
        for label, attn in sh.implementations(mode).items():
            if plains[label] is None:
                continue
            kernel, plain = plains[label]
            x = x0
            for layer in range(2):
                out = attn(x, x, x)
                ref = plain(x)
                torch_sync()
                name = f"attn_shootout {label} layer {layer} B={sh.B} H={sh.H} S={sh.S}"
                worst[kernel] = max(worst[kernel], _check_bf16_steps(name, out, ref))
                x = torch.tanh(out)
    qkv, qks, qkm2, oinv = r4.make_inputs(r4.B, dev)
    for variant in ms.Q3I_VARIANTS:
        name = f"r4_attn_decomp {variant} layer 0 B={r4.B} S={r4.S} H={r4.H}"
        worst[variant] = _check_variant(ms, name, qkv, qks, qkm2, oinv, r4.H, variant)
    return worst


def u8_images(b, s, dev, seed=0):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, (b, s, s, 3), generator=g, device=dev, dtype=torch.uint8)


def compare_normalize(pp, dev) -> float:
    """#26 against its plain version bit for bit: every u8 value in every
    channel, and a B=128, 224^2 batch."""
    import torch

    every = torch.arange(256, dtype=torch.uint8, device=dev).reshape(1, 16, 16, 1).expand(1, 16, 16, 3)
    worst = 0.0
    for name, x in (("every u8 value", every.contiguous()),
                    (f"B={MAIN_SHAPES['vision'][0]} 224^2", u8_images(MAIN_SHAPES["vision"][0], 224, dev))):
        out = pp.normalize_uint8_kernel(x)
        ref = pp.normalize_uint8_plain(x)
        torch_sync()
        equal = torch.equal(out.view(torch.int32), ref.view(torch.int32))
        err = (out - ref).abs().max().item()
        print(f"  normalize_uint8_kernel {name}: bit for bit {equal} (tolerance 0)")
        if not equal:
            raise AssertionError(f"normalize_uint8_kernel ({name}) differs from its plain version")
        worst = max(worst, err)
    return worst


def time_probe_kernels(ms, pp, dev) -> dict:
    """#4, #29 and #26 at the vision shape (plain, kernel, kernel, plain),
    each with its bound and its library yardstick: SDPA for #4, the q
    segment's copy for #29 copy, none for the others (#26 with the torch
    composition of the same arithmetic as context)."""
    import torch

    from team_tpu_torch.scripts import r4_attn_decomp as r4

    b, s, h, _ = MAIN_SHAPES["vision"]
    dh = 64
    times = {}
    q, k, v = v2_inputs(b, h, s, torch.bfloat16, dev, seed=1)
    v2_bound = bound(4 * q.numel() * 2, {"bf16": attention_ops(b, h, s, dh, False)})
    # the design's floor: its logits' FMAs at the f32 rate (rows and keys padded to 16)
    fma_floor = 2 * b * h * (-(-s // 16) * 16) ** 2 * dh / PEAK_OPS_PER_S["f32"] * 1e3
    lib = sdpa_ms(q, k, v, False)
    for exp_dtype, tag in ((torch.float32, "f32exp"), (torch.bfloat16, "bf16exp")):
        kernel = lambda e=exp_dtype: ms.fused_mha_short_v2(q, k, v, exp_dtype=e)  # noqa: E731
        plain = lambda e=exp_dtype: ms.mha_short_v2_reference(q, k, v, None, e)  # noqa: E731
        core = lambda e=exp_dtype: ms.fused_mha_short_v2_cuda_core(q, k, v, exp_dtype=e)  # noqa: E731
        p1, k1, c1, k2, c2, p2 = (_time_ms(plain), _time_ms(kernel), _time_ms(core),
                                  _time_ms(kernel), _time_ms(core), _time_ms(plain))
        times[f"v2 {tag}"] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib,
                              "cuda_core_ms": (c1 + c2) / 2, "fma_floor_ms": fma_floor,
                              **v2_bound}
        print(f"  fused_mha_short_v2 {tag} B={b} H={h} S={s} bf16: kernel {k1:.4f}/{k2:.4f} ms, "
              f"the CUDA-core kernel {c1:.4f}/{c2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
              f"scaled_dot_product_attention {lib:.4f} ms, bound {v2_bound['bound_ms']:.4f} ms "
              f"({v2_bound['bound_by']}); the design's FMA floor {fma_floor:.4f} ms")

    qkv, qks, qkm2, oinv = _variant_inputs(r4, dev, VARIANT_OINV["script"])
    d = r4.D
    vecs = (qks.numel() + qkm2.numel() + oinv.numel()) * 4
    out_bytes = b * s * d
    qk_pairs = b * h * s * s  # (query, key) pairs of a full row
    sliced_pairs = b * h * s * dh  # the first Dh keys of each row
    needs = {  # what each variant's output depends on: bytes, operations
        "copy": bound(2 * out_bytes, {}),
        "full": bound(qkv.numel() + out_bytes + vecs, {"int8": 2 * qk_pairs * dh,
                                                       "bf16": 2 * qk_pairs * (dh + 1)}),
        "qkonly": bound(out_bytes + b * dh * d + out_bytes + vecs, {"int8": 2 * sliced_pairs * dh}),
    }
    needs["noexp"] = needs["full"]
    needs["nopv"] = needs["qkonly"]
    for variant in ms.Q3I_VARIANTS:
        kernel = lambda var=variant: ms.fused_mha_q3i_variant(qkv, qks, qkm2, oinv, r4.H, var)  # noqa: E731
        plain = lambda var=variant: ms.mha_q3i_variant_reference(qkv, qks, qkm2, oinv, r4.H, var)  # noqa: E731
        p1, k1, k2, p2 = _time_ms(plain), _time_ms(kernel), _time_ms(kernel), _time_ms(plain)
        lib = _time_ms(lambda: qkv[..., :d].contiguous()) if variant == "copy" else None
        bnd = needs[variant]
        times[f"variant {variant}"] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                                       "library_ms": lib, **bnd}
        yard = f"qkv[..., :D].contiguous() {lib:.4f} ms" if lib is not None else \
            "no single PyTorch call computes it"
        print(f"  q3i variant {variant} B={b} S={s} H={h} int8: kernel {k1:.4f}/{k2:.4f} ms, "
              f"plain {p1:.4f}/{p2:.4f} ms, {yard}, bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']})")

    x = u8_images(b, 224, dev, seed=1)
    mean = torch.tensor(pp.CLIP_MEAN, device=dev)
    std = torch.tensor(pp.CLIP_STD, device=dev)
    p1, k1, k2, p2 = (_time_ms(lambda: pp.normalize_uint8_plain(x)),
                      _time_ms(lambda: pp.normalize_uint8_kernel(x)),
                      _time_ms(lambda: pp.normalize_uint8_kernel(x)),
                      _time_ms(lambda: pp.normalize_uint8_plain(x)))
    comp = _time_ms(lambda: (x.float() / 255.0 - mean) / std)
    bnd = bound(x.numel() * 5, {"f32": 2 * x.numel()})
    times["normalize_uint8"] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": None,
                                "composition_ms": comp, **bnd}
    print(f"  normalize_uint8_kernel B={b} 224^2: kernel {k1:.4f}/{k2:.4f} ms, plain "
          f"{p1:.4f}/{p2:.4f} ms, no single PyTorch call computes it (the composition "
          f"(x.float() / 255 - mean) / std {comp:.4f} ms), bound {bnd['bound_ms']:.4f} ms "
          f"({bnd['bound_by']})")
    return times


def run_probe_paths(ms, pp, dev) -> dict:
    """The probe entry points, each with the counts zeroed just before it
    and read just after: the attention shoot-out (MODE all, then the q_pad=128
    mode) and the q3i decomposition probe at their own shapes (B=256), and
    #26 through the library API at B=128, 224^2. Each must launch its kernel."""
    from team_tpu_torch.scripts import attn_shootout, r4_attn_decomp

    res = {}
    ms.reset_launch_counts()
    t0 = time.perf_counter()
    res["shootout"] = {**attn_shootout.main([]), **attn_shootout.main(["--mode", "qpad128"])}
    res["shootout_wall_s"] = time.perf_counter() - t0
    res["v2_launches"] = ms.fused_mha_short_v2.launches
    print(f"  attn_shootout: fused_mha_short_v2 launched {res['v2_launches']} times "
          f"(fused_mha_short {ms.fused_mha_short.launches}), {res['shootout_wall_s']:.2f} s")
    if res["v2_launches"] == 0:
        raise AssertionError("attn_shootout did not launch fused_mha_short_v2")

    ms.reset_launch_counts()
    t0 = time.perf_counter()
    res["decomp"] = r4_attn_decomp.main([])
    res["decomp_wall_s"] = time.perf_counter() - t0
    res["variant_launches"] = dict(ms.fused_mha_q3i_variant.launches)
    print(f"  r4_attn_decomp: variant launches {res['variant_launches']}, "
          f"{res['decomp_wall_s']:.2f} s")
    if not all(res["variant_launches"].values()):
        raise AssertionError("r4_attn_decomp did not launch every variant")

    x = u8_images(MAIN_SHAPES["vision"][0], 224, dev, seed=2)
    pp.normalize_uint8_kernel.launches = 0
    out = pp.normalize_uint8_kernel(x)
    torch_sync()
    res["normalize_launches"] = pp.normalize_uint8_kernel.launches
    print(f"  normalize_uint8_kernel (library API) B={x.shape[0]} 224^2: "
          f"{res['normalize_launches']} launch, out {tuple(out.shape)} {out.dtype}")
    if res["normalize_launches"] != 1 or tuple(out.shape) != tuple(x.shape):
        raise AssertionError("the library API did not launch normalize_uint8_kernel once")
    return res


def check_resize(pp, dev) -> float:
    """Fault 3.2's repair: the bicubic resize on the card against the same
    function on the CPU, up and down, within RESIZE_TOL."""
    import torch

    worst = 0.0
    for i, (shape, label) in enumerate(RESIZE_CASES):
        g = torch.Generator().manual_seed(10 + i)
        x = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)
        for flip in (False, True):
            got = pp.preprocess_batch(x.to(dev), 224, flip=flip)
            want = pp.preprocess_batch(x, 224, flip=flip)
            err = (got.cpu() - want).abs().max().item()
            print(f"  resize {label} flip={flip}: card vs CPU max |diff| {err:.3e} "
                  f"(tol {RESIZE_TOL:g}), out {tuple(got.shape)}")
            if tuple(got.shape) != (shape[0], 224, 224, 3) or not err <= RESIZE_TOL:
                raise AssertionError(f"resize {label}: card and CPU disagree")
            worst = max(worst, err)
    return worst


def openclip_shapes(cfg) -> dict:
    """The key and shape of every array that ``convert_openclip_state_dict``
    reads from an open_clip checkpoint of ``cfg``'s towers (a
    ``team_tpu_torch`` ``CLIPConfig``)."""
    v, t = cfg.vision, cfg.text

    def blocks(prefix: str, layers: int, w: int) -> dict:
        shapes = {}
        for i in range(layers):
            p = f"{prefix}{i}."
            shapes.update({
                p + "ln_1.weight": (w,), p + "ln_1.bias": (w,),
                p + "attn.in_proj_weight": (3 * w, w), p + "attn.in_proj_bias": (3 * w,),
                p + "attn.out_proj.weight": (w, w), p + "attn.out_proj.bias": (w,),
                p + "ln_2.weight": (w,), p + "ln_2.bias": (w,),
                p + "mlp.c_fc.weight": (4 * w, w), p + "mlp.c_fc.bias": (4 * w,),
                p + "mlp.c_proj.weight": (w, 4 * w), p + "mlp.c_proj.bias": (w,)})
        return shapes

    return {
        "visual.conv1.weight": (v.width, 3, v.patch_size, v.patch_size),
        "visual.class_embedding": (v.width,),
        "visual.positional_embedding": (v.seq_len, v.width),
        "visual.ln_pre.weight": (v.width,), "visual.ln_pre.bias": (v.width,),
        **blocks("visual.transformer.resblocks.", v.layers, v.width),
        "visual.ln_post.weight": (v.width,), "visual.ln_post.bias": (v.width,),
        "visual.proj": (v.width, cfg.embed_dim),
        "token_embedding.weight": (t.vocab_size, t.width),
        "positional_embedding": (t.context_length, t.width),
        **blocks("transformer.resblocks.", t.layers, t.width),
        "ln_final.weight": (t.width,), "ln_final.bias": (t.width,),
        "text_projection": (t.width, cfg.embed_dim),
        "logit_scale": (),
    }


def synthetic_openclip_npz(path: str, seed: int = 0) -> dict:
    """A seeded open_clip-format state dict of ViT-B/16's keys and shapes,
    every array random (no checkpoint exists here), saved as ``.npz``."""
    import numpy as np

    from team_tpu_torch.backbone.clip import CLIPConfig

    rng = np.random.default_rng(seed)
    sd = {k: (rng.standard_normal(shape) * (0.02 if len(shape) > 1 else 0.1)
              + (1.0 if k.endswith(("ln_1.weight", "ln_2.weight")) else 0.0)).astype(np.float32)
          for k, shape in openclip_shapes(CLIPConfig.vit_b16()).items()}
    sd["logit_scale"] = np.asarray(np.log(1 / 0.07), dtype=np.float32)
    np.savez(path, **sd)
    return sd


def _loaded_leaves(tree, sd):
    """(name, loaded leaf, the source array in the tree's layout) for every
    kind of entry the loader converts: the patch kernel, the embeddings, the
    layer norms and projections of both towers, every array of one block of
    each tower, logit_scale."""
    v, t = tree["vision"], tree["text"]
    conv = sd["visual.conv1.weight"]
    out = [("vision.patch_w", v["patch_w"], conv.reshape(conv.shape[0], -1).T),
           ("vision.cls", v["cls"], sd["visual.class_embedding"]),
           ("vision.pos", v["pos"], sd["visual.positional_embedding"]),
           ("vision.ln_pre.scale", v["ln_pre"]["scale"], sd["visual.ln_pre.weight"]),
           ("vision.ln_post.bias", v["ln_post"]["bias"], sd["visual.ln_post.bias"]),
           ("vision.proj", v["proj"], sd["visual.proj"]),
           ("text.token_embedding", t["token_embedding"], sd["token_embedding.weight"]),
           ("text.pos", t["pos"], sd["positional_embedding"]),
           ("text.ln_final.bias", t["ln_final"]["bias"], sd["ln_final.bias"]),
           ("text.proj", t["proj"], sd["text_projection"]),
           ("logit_scale", tree["logit_scale"], sd["logit_scale"])]
    block = (("ln_1", "scale", "ln_1.weight", False), ("ln_1", "bias", "ln_1.bias", False),
             ("attn", "qkv_w", "attn.in_proj_weight", True), ("attn", "qkv_b", "attn.in_proj_bias", False),
             ("attn", "out_w", "attn.out_proj.weight", True), ("attn", "out_b", "attn.out_proj.bias", False),
             ("ln_2", "scale", "ln_2.weight", False), ("ln_2", "bias", "ln_2.bias", False),
             ("mlp", "fc_w", "mlp.c_fc.weight", True), ("mlp", "fc_b", "mlp.c_fc.bias", False),
             ("mlp", "proj_w", "mlp.c_proj.weight", True), ("mlp", "proj_b", "mlp.c_proj.bias", False))
    for tower, prefix in (("vision", "visual.transformer.resblocks."),
                          ("text", "transformer.resblocks.")):
        i = len(tree[tower]["blocks"]) // 2
        for sub, leaf, key, transposed in block:
            src = sd[f"{prefix}{i}.{key}"]
            out.append((f"{tower}.blocks[{i}].{sub}.{leaf}", tree[tower]["blocks"][i][sub][leaf],
                        src.T if transposed else src))
    return out


def check_loader(log_dir: str) -> dict:
    """Fault 3.8's repair at full ViT-B/16 width: a seeded synthetic open_clip
    state dict saved as .npz; the loader's tree equals the source arrays
    (every kind of entry, both towers' block counts); TEAM_CLIP_CHECKPOINT
    naming the file loads it into the runtime (allow_byte_tokenizer set),
    whose tree and one encode equal the runtime given the loader's tree
    through ``params=``; without allow_byte_tokenizer the runtime raises
    FileNotFoundError (no BPE vocabulary), as team_tpu does."""
    import numpy as np
    import torch

    from team_tpu_torch.backbone.clip import CLIPConfig
    from team_tpu_torch.backbone.import_weights import load_clip_checkpoint
    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime

    path = os.path.join(log_dir, "openclip_synthetic.npz")
    sd = synthetic_openclip_npz(path)
    clip_cfg = CLIPConfig.vit_b16()
    tree = load_clip_checkpoint(path, clip_cfg)
    leaves = _loaded_leaves(tree, sd)
    tree_equal = (len(tree["vision"]["blocks"]) == clip_cfg.vision.layers
                  and len(tree["text"]["blocks"]) == clip_cfg.text.layers
                  and all(leaf.dtype == torch.float32 and np.array_equal(leaf.numpy(), src)
                          for _, leaf, src in leaves))
    cfg = smoke_config("simplecil", "bfloat16", log_dir, extras={"allow_byte_tokenizer": True})
    with knobs({"TEAM_CLIP_CHECKPOINT": path}):
        rt = BackboneRuntime(cfg)
        with expect_raise(FileNotFoundError):
            BackboneRuntime(smoke_config("simplecil", "bfloat16", log_dir))
    ref_rt = BackboneRuntime(cfg, params=tree)
    runtime_equal = all(torch.equal(a, b) for a, b in zip(_leaves(rt.params), _leaves(ref_rt.params)))
    images = u8_images(8, 224, rt.device, seed=4)
    feats, want = rt.encode_image(images), ref_rt.encode_image(images)
    torch_sync()
    encode_equal = torch.equal(feats, want) and bool(torch.isfinite(feats).all())
    print(f"  loader: {len(sd)} open_clip arrays (ViT-B/16) from a .npz; {len(leaves)} leaves of "
          f"every kind equal the source arrays {tree_equal}; the runtime under "
          f"TEAM_CLIP_CHECKPOINT equals params= leaf by leaf {runtime_equal}, one encode "
          f"{tuple(feats.shape)} equal {encode_equal}")
    if not (tree_equal and runtime_equal and encode_equal):
        raise AssertionError("the open_clip loader's tree or encode differs")
    return {"arrays": len(sd), "leaves_checked": len(leaves)}


# ---------------------------------------------------------------------------
# the GEMM probes (#27 probe_mm, #28 mxu_ceiling, #30 mlp_mega)
# ---------------------------------------------------------------------------

def _probe_inputs(dev) -> dict:
    """The three probes' own inputs at their own shapes (the scripts' draws):
    int8_probe's first x and w (M = N = K = 4096) and their bf16 casts, the
    ceiling's int8 and bf16 x and w, the megakernel's weights and first input."""
    import torch

    from team_tpu_torch.ops import gemm_probe as gp
    from team_tpu_torch.scripts import int8_mxu_ceiling as mc
    from team_tpu_torch.scripts import int8_probe as ip
    from team_tpu_torch.scripts import r5_megakernel_probe as r5

    xs, w = ip.make_inputs(ip.SIZE, dev)
    params, inputs = r5.make_inputs(r5.B, 1, dev)
    return {"mm": (xs[0], w), "mm_bf16": (xs[0].to(torch.bfloat16),
                                         gp.column_major(w.to(torch.bfloat16))),
            "ceiling": {dt: mc.make_inputs(dt, mc.M, mc.K, dev) for dt in (torch.int8, torch.bfloat16)},
            "mega": (inputs[0], params)}


def compare_gemm_probes(gp, inp) -> dict:
    """#27, #28 and #30 against their plain versions at the probes' own shapes
    and inputs: probe_mm int8 bit for bit over the whole 4096 x 4096 output,
    bf16 within (K/16 + 1) ulps of |x|@|w|; mxu_ceiling int8 bit for bit, bf16
    within CEILING_BF16_SHARE of the largest |ref|, both equal bit for bit
    over two launches; mlp_mega_2d and _3d equal
    bit for bit and within mlp_mega_limit of the plain version (the float
    intermediate checked finite first), with the share of rows that differ."""
    import torch

    from team_tpu_torch.scripts import int8_mxu_ceiling as mc

    err = {}
    x, w = inp["mm"]
    out, ref = gp.probe_mm(x, w), gp.probe_mm_reference(x, w)
    torch_sync()
    if not torch.equal(out, ref):
        raise AssertionError("probe_mm int8 differs from the exact product")
    print(f"  probe_mm int8 M=N=K={x.shape[0]}: bit for bit the exact product (tolerance 0)")
    err["probe_mm int8"] = 0.0
    xb, wb = inp["mm_bf16"]
    out, ref = gp.probe_mm(xb, wb), gp.probe_mm_reference(xb, wb)
    limit = gp.probe_mm_bf16_limit(xb, wb)
    torch_sync()
    diff = (out - ref).abs()
    err["probe_mm bf16"] = diff.max().item()
    print(f"  probe_mm bf16 M=N=K={xb.shape[0]}: max_abs_err={err['probe_mm bf16']:.3e}, "
          f"{100 * (diff > 0).float().mean().item():.4f} % of outputs differ, worst at "
          f"{(diff / limit).max().item():.3f} of the limit ((K/16 + 1) ulps of |x|@|w|)")
    if not bool((diff <= limit).all()):
        raise AssertionError("probe_mm bf16 disagrees with its plain version")

    for dtype, (x, w) in inp["ceiling"].items():
        tag = "int8" if dtype == torch.int8 else "bf16"
        out, ref = gp.mxu_ceiling(x, w, mc.REPS, mc.M), gp.mxu_ceiling_reference(x, w, mc.REPS, mc.M)
        again = gp.mxu_ceiling(x, w, mc.REPS, mc.M)
        torch_sync()
        print(f"  mxu_ceiling {tag}: two launches bit for bit {torch.equal(out, again)}")
        if not torch.equal(out, again):
            raise AssertionError(f"mxu_ceiling {tag} differs between two launches")
        e = (out - ref).abs().max().item()
        err[f"mxu_ceiling {tag}"] = e
        if dtype == torch.int8:
            ok = torch.equal(out, ref)
            print(f"  mxu_ceiling int8 M={mc.M} K=N={mc.K} REPS={mc.REPS}: bit for bit {ok} "
                  "(tolerance 0)")
        else:
            tol = gp.CEILING_BF16_SHARE * ref.abs().max().item()
            ok = e <= tol
            print(f"  mxu_ceiling bf16 M={mc.M} K=N={mc.K} REPS={mc.REPS}: max_abs_err={e:.3e} "
                  f"(tol {tol:.3e}, 2^-10 of max |ref| {ref.abs().max().item():.3f})")
        if not ok:
            raise AssertionError(f"mxu_ceiling {tag} disagrees with its plain version")

    x, (w1, s1, w2, s2, qi) = inp["mega"]
    b, s, k = x.shape
    out3 = gp.mlp_mega_3d(x, w1, s1, w2, s2, qi)
    out2 = gp.mlp_mega_2d(x.reshape(b * s, k), w1, s1, w2, s2, qi)
    torch_sync()
    if not torch.equal(out2.reshape(x.shape), out3):
        raise AssertionError("mlp_mega_2d and mlp_mega_3d differ")
    hidden = gp.mlp_mega_hidden(x, w1, s1, qi)
    if not all(bool(torch.isfinite(t).all()) for t in hidden.values()):
        raise AssertionError("mlp_mega: the plain float intermediate is not finite")
    saturated = (hidden["v"].abs() >= 127).float().mean().item()
    del hidden
    ref = gp.mlp_mega_reference(x, w1, s1, w2, s2, qi)
    edges = gp.mlp_mega_edge_rows(x, w1, s1, qi)
    limit = gp.mlp_mega_limit(ref, edges, s2)
    diff = (out3.float() - ref.float()).abs()
    rows_differ = (diff.reshape(b * s, -1).amax(dim=1) > 0).float().mean().item()
    err["mlp_mega"] = diff.max().item()
    err["mlp_mega rows differing"] = rows_differ
    print(f"  mlp_mega B={b} S={s} K={k} N={w1.shape[1]}: 2-D and 3-D bit for bit; "
          f"max_abs_err={err['mlp_mega']:.3e}, {100 * rows_differ:.4f} % of rows differ, "
          f"{100 * (edges > 0).float().mean().item():.4f} % of rows hold an hq near a rounding "
          f"edge ({int(edges.sum())} values), {100 * saturated:.1f} % of hq at +-127; limit 127 s2 "
          "per near-edge value of the row plus one bf16 step (rows without one: bit for bit)")
    if not bool((diff <= limit).all()):
        raise AssertionError("mlp_mega disagrees with its plain version")
    return err


def time_gemm_probes(gp, inp) -> dict:
    """#27, #28 and #30 at the probes' shapes (plain, kernel, kernel, plain),
    each with its bound and its library call: torch._int_mm and torch.matmul
    (bf16 out) for #27, none for #28, the torch composition (the probe's
    xla variant) for #30."""
    import torch

    from team_tpu_torch.scripts import int8_mxu_ceiling as mc
    from team_tpu_torch.scripts import r5_megakernel_probe as r5

    times = {}

    def four(kernel, plain):
        p1, k1, k2, p2 = _time_ms(plain), _time_ms(kernel), _time_ms(kernel), _time_ms(plain)
        return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "k": (k1, k2), "p": (p1, p2)}

    for tag, (x, w), lib_name, lib in (
            ("int8", inp["mm"], "torch._int_mm", torch._int_mm),
            ("bf16", inp["mm_bf16"], "torch.matmul (bf16 out)", torch.matmul)):
        m, k = x.shape
        n = w.shape[1]
        t = four(lambda: gp.probe_mm(x, w), lambda: gp.probe_mm_reference(x, w))
        t["library_ms"] = _time_ms(lambda: lib(x, w))
        esz = x.element_size()
        t.update(bound((m * k + k * n) * esz + m * n * 4, {tag: 2 * m * n * k}))
        t["tops"] = 2 * m * n * k / t["ms"] / 1e9
        times[f"probe_mm {tag}"] = t
        print(f"  probe_mm {tag} M=N=K={m}: kernel {t['k'][0]:.4f}/{t['k'][1]:.4f} ms "
              f"({t['tops']:.1f} TOP/s), plain {t['p'][0]:.4f}/{t['p'][1]:.4f} ms, {lib_name} "
              f"{t['library_ms']:.4f} ms ({2 * m * n * k / t['library_ms'] / 1e9:.1f} TOP/s), "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})")

    for dtype, (x, w) in inp["ceiling"].items():
        tag = "int8" if dtype == torch.int8 else "bf16"
        ops = 2 * mc.M * mc.K * mc.K * mc.REPS
        t = four(lambda: gp.mxu_ceiling(x, w, mc.REPS, mc.M),
                 lambda: gp.mxu_ceiling_reference(x, w, mc.REPS, mc.M))
        t["library_ms"] = None
        t.update(bound(x.numel() * x.element_size() + w.numel() * w.element_size()
                       + mc.M * mc.K * 4, {tag: ops}))
        t["tops"] = ops / t["ms"] / 1e9
        t["peak_share"] = t["tops"] / (PEAK_OPS_PER_S[tag] / 1e12)
        times[f"mxu_ceiling {tag}"] = t
        print(f"  mxu_ceiling {tag} M={mc.M} K=N={mc.K} REPS={mc.REPS}: kernel "
              f"{t['k'][0]:.4f}/{t['k'][1]:.4f} ms ({t['tops']:.1f} TOP/s, the wgmma ceiling, "
              f"{100 * t['peak_share']:.1f} % of the dense peak), plain "
              f"{t['p'][0]:.4f}/{t['p'][1]:.4f} ms, no single PyTorch call computes it, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']})")

    x, params = inp["mega"]
    x2 = x.reshape(-1, x.shape[-1])
    m, k = x2.shape
    n = params[0].shape[1]
    t = four(lambda: gp.mlp_mega_2d(x2, *params), lambda: gp.mlp_mega_reference(x2, *params))
    t["library_ms"] = _time_ms(lambda: r5.xla_pair(x2, *params))
    t.update(bound(m * k + 2 * k * n + m * k * 2 + (2 * n + k) * 4, {"int8": 4 * m * k * n}))
    t["tops"] = 4 * m * k * n / t["ms"] / 1e9
    times["mlp_mega"] = t
    print(f"  mlp_mega M={m} K={k} N={n}: kernel {t['k'][0]:.4f}/{t['k'][1]:.4f} ms "
          f"({t['tops']:.1f} TOP/s), plain {t['p'][0]:.4f}/{t['p'][1]:.4f} ms, the torch "
          f"composition (xla_pair) {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']})")
    return times


def run_gemm_probe_paths(gp) -> dict:
    """The three GEMM probe entry points at their own shapes, each with the
    counts zeroed just before it and read just after; each must launch its
    kernels (the megakernel probe both entries)."""
    from team_tpu_torch.scripts import int8_mxu_ceiling, int8_probe, r5_megakernel_probe

    res = {}
    for name, probe, counted in (("int8_probe", int8_probe, ("probe_mm",)),
                                 ("int8_mxu_ceiling", int8_mxu_ceiling, ("mxu_ceiling",)),
                                 ("r5_megakernel_probe", r5_megakernel_probe,
                                  ("mlp_mega_2d", "mlp_mega_3d"))):
        gp.reset_launch_counts()
        t0 = time.perf_counter()
        res[name] = probe.main([])
        res[f"{name}_wall_s"] = time.perf_counter() - t0
        launches = {c: getattr(gp, c).launches for c in counted}
        res[f"{name}_launches"] = launches
        print(f"  {name}: launches {launches}, {res[f'{name}_wall_s']:.2f} s")
        if not all(launches.values()):
            raise AssertionError(f"{name} did not launch {counted}")
    return res


# ---------------------------------------------------------------------------
# the backwards of #1, #3, #13 and #14, Grad-CAM, the full-protocol runner
# and checkpoint/resume
# ---------------------------------------------------------------------------

# the towers' shapes for the backwards: (batch, seq, heads, causal)
BACKWARD_SHAPES = {"vision": (8, 197, 12, False), "text": (8, 77, 8, True)}
# the gradient through a kernel's Function against autograd of its plain
# reference, as a share of the reference gradient's largest |value|: both
# backwards are the same recompute, so they differ only through the
# cotangent, which depends on the forward (kernel against plain reference)
BACKWARD_TOL = {"torch.float32": 1e-4, "torch.bfloat16": 2e-2}
# Grad-CAM's [0, 1] maps on a kernel route against the plain route (f32)
GRADCAM_TOL = 1e-3
GRADCAM_ROUTES = {"auto": "fused_mha_packed", "mha_short": "fused_mha_short",
                  "attn_block": "fused_attn_block", "pallas": "flash_attention"}


def _grad_pair(name: str, kernel, plain, inputs: dict, dtype) -> float:
    """d/d inputs of sum(tanh(out) * w) through ``kernel`` (the wrapper, so
    its autograd Function) and through ``plain`` (autograd of the plain
    reference); raises past BACKWARD_TOL or where a gradient is missing."""
    import torch

    grads = {}
    for label, fn in (("kernel", kernel), ("plain", plain)):
        leaves = {k: t.detach().clone().requires_grad_(True) for k, t in inputs.items()}
        out = fn(**leaves)
        w = torch.randn(out.shape, generator=torch.Generator(device=out.device).manual_seed(7),
                        device=out.device)
        loss = (torch.tanh(out.float()) * w).sum()
        grads[label] = torch.autograd.grad(loss, list(leaves.values()))
    torch_sync()
    worst = 0.0
    for key, gk, gp in zip(inputs, grads["kernel"], grads["plain"]):
        scale = gp.float().abs().max().item()
        err = (gk.float() - gp.float()).abs().max().item() / max(scale, 1e-30)
        worst = max(worst, err)
        if not (math.isfinite(err) and scale > 0 and gk.dtype == gp.dtype
                and err <= BACKWARD_TOL[str(dtype)]):
            raise AssertionError(f"{name}: d{key} through the kernel disagrees with the plain "
                                 f"reference's ({err:.3e} of max {scale:.3e})")
    print(f"  {name} {dtype}: gradients of {', '.join(inputs)} within {worst:.3e} of their max "
          f"(tol {BACKWARD_TOL[str(dtype)]:g})")
    return worst


def compare_backward(ms, fa, dev) -> dict:
    """The backwards of #1, #3, #13 and #14 at the towers' shapes (vision
    B=8, S=197, H=12; text S=77, H=8, causal; #3 the image tower only), f32
    and bf16, against autograd of their plain references; each kernel
    launched once a forward. Then #12 refuses an input that requires grad."""
    import torch

    worst = dict.fromkeys(("fused_mha_packed", "fused_mha_short", "fused_attn_block",
                           "flash_attention"), 0.0)
    ms.reset_launch_counts()
    fa.reset_launch_counts()
    for tower, (b, s, h, causal) in BACKWARD_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            inp = fused_inputs(b, s, h, dtype, dev, seed=11)
            tag = f"{tower} B={b} S={s} H={h} causal={causal}"
            worst["fused_mha_packed"] = max(worst["fused_mha_packed"], _grad_pair(
                f"fused_mha_packed backward {tag}",
                lambda qkv: ms.fused_mha_packed(qkv, h, causal=causal),
                lambda qkv: ms.mha_packed_backward_reference(qkv, h, causal),
                {"qkv": inp["qkv"]}, dtype))
            ln, attn = inp["ln"], inp["attn"]
            block = dict(x=inp["x"], ln_scale=ln[0], ln_bias=ln[1], qkv_w=attn[0], qkv_b=attn[1],
                         out_w=attn[2], out_b=attn[3])
            worst["fused_attn_block"] = max(worst["fused_attn_block"], _grad_pair(
                f"fused_attn_block backward {tag}",
                lambda **a: ms.fused_attn_block(*a.values(), h, causal=causal),
                lambda **a: ms.attn_block_backward_reference(*a.values(), h, causal),
                block, dtype))
            kv_len = s if causal else s * 3 // 4
            q, k, v = flash_inputs((b, h, s, causal, kv_len), dtype, dev, seed=12)
            worst["flash_attention"] = max(worst["flash_attention"], _grad_pair(
                f"flash_attention backward {tag} kv_len={kv_len}",
                lambda q, k, v: fa.flash_attention(q, k, v, kv_len, causal=causal),
                lambda q, k, v: fa.xla_attention(q, k, v, kv_len, causal=causal),
                {"q": q, "k": k, "v": v}, dtype))
            if not causal:
                worst["fused_mha_short"] = max(worst["fused_mha_short"], _grad_pair(
                    f"fused_mha_short backward {tag} kv_len={kv_len}",
                    lambda q, k, v: ms.fused_mha_short(q, k, v, kv_len),
                    lambda q, k, v: fa.xla_attention(q, k, v, kv_len),
                    {"q": q, "k": k, "v": v}, dtype))
    got = {"fused_mha_packed": ms.fused_mha_packed.launches,
           "fused_mha_short": ms.fused_mha_short.launches,
           "fused_attn_block": ms.fused_attn_block.launches,
           "flash_attention": fa.flash_attention.launches}
    want = {"fused_mha_packed": 4, "fused_mha_short": 2, "fused_attn_block": 4,
            "flash_attention": 4}
    print(f"  kernel launches in the backward checks {got} (one a forward)")
    if got != want:
        raise AssertionError(f"the backward checks launched {got}, want {want}")
    inp = fused_inputs(2, 77, 8, torch.bfloat16, dev, seed=13)
    qkv = inp["qkv"].clone().requires_grad_(True)
    print("  fused_mha_packed_proj (#12) on an input that requires grad:")
    with expect_raise(RuntimeError):
        ms.fused_mha_packed_proj(qkv, inp["attn"][2], inp["attn"][3], inp["x"], 8, causal=True)
    return worst


def check_gradcam(ms, fa, dev) -> dict:
    """Grad-CAM at full ViT-B/16 width (random init from a seed, B=4
    normalized images, float32) on each kernel route against the plain
    route: the [0, 1] maps within GRADCAM_TOL, the route's kernel launched
    once a layer (its forward; its backward is the plain recompute)."""
    import torch

    from team_tpu_torch.analysis.gradcam import grad_cam
    from team_tpu_torch.backbone.clip import CLIPConfig, init_clip_params
    from team_tpu_torch.bridge import tree_to

    cfg = CLIPConfig.vit_b16()
    params = tree_to(init_clip_params(torch.Generator().manual_seed(0), cfg), dev)
    g = torch.Generator(device=dev).manual_seed(5)
    size = cfg.vision.image_size
    images = torch.randn((4, size, size, 3), generator=g, device=dev)
    target = torch.randn((cfg.embed_dim,), generator=g, device=dev)
    t0 = time.perf_counter()
    want = grad_cam(params, images, target, cfg, attn_impl="xla")
    torch_sync()
    plain_s = time.perf_counter() - t0
    out = {"plain_s": plain_s}
    for route, counter in GRADCAM_ROUTES.items():
        ms.reset_launch_counts()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        cam = grad_cam(params, images, target, cfg, attn_impl=route)
        torch_sync()
        wall = time.perf_counter() - t0
        launches = getattr(ms, counter, None) or getattr(fa, counter)
        err = (cam - want).abs().max().item()
        print(f"  grad_cam on {route} ({counter}, forward launches {launches.launches}): "
              f"maps [{cam.shape[0]}, {cam.shape[1]}, {cam.shape[2]}] in [{cam.min().item():.3f}, "
              f"{cam.max().item():.3f}], max |cam - cam_xla| {err:.3e} (tol {GRADCAM_TOL:g}); "
              f"{wall:.2f} s (xla {plain_s:.2f} s)")
        if (cam.shape != want.shape or not math.isfinite(err) or err > GRADCAM_TOL
                or launches.launches != cfg.vision.layers):
            raise AssertionError(f"grad_cam on {route} disagrees with the plain route or did not "
                                 "go through its kernel once a layer")
        out[route] = {"max_abs_err": err, "launches": launches.launches, "wall_s": wall}
    return out


# the protocol task and epoch whose wall full_protocol_worker profiles
PROFILED = {"task": 4, "epoch": 0}


def run_full_protocol() -> dict:
    """team_tpu_torch.scripts.full_protocol in a fresh process (this script
    with --full-protocol, as a user runs it): PROOF in bf16, ten tasks at the
    flagship's shape, pinned to its committed golden; its wall time, phase
    sums, and the device's busy share over one profiled epoch."""
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--full-protocol"],
                         capture_output=True, text=True, timeout=900)
    lines = [ln for ln in out.stdout.splitlines() if not ln.startswith("20")]
    print("\n".join("    " + ln for ln in lines[:-1]))
    if out.returncode != 0:
        raise AssertionError(f"the full protocol failed:\n{out.stdout[-3000:]}{out.stderr[-3000:]}")
    res = json.loads(lines[-1])
    busy = res["busy"]
    print(f"  full protocol proof/bf16 (fresh process): {res['wall_s']:.1f} s, avg "
          f"{res['avg']:.4f}, {res['pin']}; task {busy['task']} epoch {busy['epoch']} "
          f"(profiled) {busy['wall_s']:.3f} s, device kernel time {busy['device_s']:.3f} s "
          f"({100 * busy['share']:.1f} % busy, {busy['kernels']} kernels)")
    if len(res["curve"]) != 10:
        raise AssertionError(f"full protocol: expected ten tasks, got {res['curve']}")
    return res


def full_protocol_worker() -> int:
    """The body of run_full_protocol, in its own process: the run, with
    torch.profiler over one epoch of one task (from its first train step to
    the next epoch's first: the steps, the test accuracy and the evolution);
    the last line is the result as JSON."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from team_tpu_torch.learners import proof as proof_learner
    from team_tpu_torch.scripts import full_protocol as fp
    from team_tpu_torch.utils import phase_timer

    phase_timer.enable(True)  # fp.run prints the span report
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    step, state, busy = proof_learner.train_step, {}, {}

    def train_step(tr, opt, batch, ctx, buffers, epoch, *a, **k):
        here = state.get("task") == PROFILED["task"]
        if here and epoch == PROFILED["epoch"] and "prof" not in state:
            torch.cuda.synchronize()
            state["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            state["prof"].start()
            state["t0"] = time.perf_counter()
        elif here and epoch == PROFILED["epoch"] + 1 and not busy:
            torch.cuda.synchronize()
            wall = time.perf_counter() - state["t0"]
            state["prof"].stop()
            kernels = [e for e in state["prof"].key_averages()
                       if str(e.device_type).endswith("CUDA")]
            device = sum(e.self_device_time_total for e in kernels) / 1e6
            busy.update(PROFILED, wall_s=wall, device_s=device, share=device / wall,
                        kernels=sum(e.count for e in kernels))
        return step(tr, opt, batch, ctx, buffers, epoch, *a, **k)

    def count_tasks(learner):
        train_task = learner.incremental_train

        def incremental_train(dm):
            state["task"] = learner._cur_task + 1
            return train_task(dm)

        learner.incremental_train = incremental_train

    proof_learner.train_step = train_step
    with tempfile.TemporaryDirectory() as log_dir, \
            recording(proof_learner.Learner, count_tasks):
        res = fp.run(fp.protocol_config("proof", "bf16", device=[0], log_dir=log_dir), pin="1")
    if not busy:
        raise AssertionError(f"task {PROFILED['task']} epoch {PROFILED['epoch']} was not profiled")
    print(json.dumps({"wall_s": res["wall_s"], "avg": res["avg"], "curve": res["curve"],
                      "pin": res["pin"], "phase_sums": {k: v["sum"] for k, v in
                                                        res["phases"]["spans"].items()}, "busy": busy}))
    return 0


def run_resume(log_dir: str) -> dict:
    """PROOF (bf16, batch 16, tuned_epoch 2, the default route) with
    checkpoint_dir: the whole run, then its last task's file deleted and the
    run resumed; the resumed curves equal the whole run's bit for bit."""
    from team_tpu_torch.trainer import train

    ckpt = os.path.join(log_dir, "resume_ckpt")

    def cfg(resume):
        return smoke_config("proof", "bfloat16", os.path.join(log_dir, "resume"),
                            batch_size=FLAGSHIP_BATCH, tuned_epoch=2, checkpoint_dir=ckpt,
                            resume=resume)

    t0 = time.perf_counter()
    whole = train(cfg(False))
    whole_s = time.perf_counter() - t0
    files = sorted(os.listdir(ckpt))
    os.remove(os.path.join(ckpt, "task_1.pt"))
    t0 = time.perf_counter()
    resumed = train(cfg(True))
    resumed_s = time.perf_counter() - t0
    keys = ("cnn_top1", "cnn_top5", "nme_top1")
    print(f"  proof with checkpoint_dir: files {files}; whole run {whole_s:.2f} s "
          f"{[whole[k] for k in keys]}; resumed from task 0 in {resumed_s:.2f} s "
          f"{[resumed[k] for k in keys]}")
    if files != ["task_0.pt", "task_1.pt"] or any(
            [float(a) for a in whole[k]] != [float(a) for a in resumed[k]] for k in keys):
        raise AssertionError("the resumed run's curves differ from the whole run's")
    return {"whole_s": whole_s, "resumed_s": resumed_s, "curve": [float(a) for a in whole["cnn_top1"]]}


def _leaves(tree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, list):
        for item in tree:
            yield from _leaves(item)
    else:
        yield tree


@contextlib.contextmanager
def expect_raise(exc):
    """Fail unless the block raises ``exc``."""
    try:
        yield
    except exc as e:
        print(f"  raised {type(e).__name__}: {str(e)[:100]}")
        return
    raise AssertionError(f"expected {exc.__name__}")


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    try:
        from team_tpu_torch.backbone import quant
        from team_tpu_torch.ops import _build
        from team_tpu_torch.ops import flash_attention as fa
        from team_tpu_torch.ops import gemm_probe as gp
        from team_tpu_torch.ops import int8_matmul as im
        from team_tpu_torch.ops import mha_short as ms
        from team_tpu_torch.ops import preprocess as pp
        from team_tpu_torch.ops import tower_bf16 as tb
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the repository root",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    print("phase 1: card")
    print(_card())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off for matmul and cuDNN")

    print("phase 2: build (one nvcc per source, all started together)")
    t0 = time.perf_counter()
    _build.build_all(SOURCES)
    ms.build()
    fa.build()
    im.build()
    pp.build()
    gp.build()
    tb.build()
    print(f"  {', '.join(SOURCES)} built and loaded in {time.perf_counter() - t0:.2f} s")
    for source in SOURCES:
        for line in _build.BUILD_LOGS.get(source, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {source}: " + line.strip())
    hmma = check_tensor_cores(_build, without=NO_PV_INSTANCES)
    gmma = check_tensor_cores(_build, GMMA_SOURCES, "GMMA")
    imma = check_tensor_cores(_build, IMMA_SOURCES, "IMMA")
    check_no_spills(_build)

    print("phase 3: kernels vs plain versions")
    max_err = compare_kernel(ms, dev)
    q3i_err = compare_q3i(ms, dev)
    q3i_err.update(compare_q3i_modes(ms, dev))
    q3i_err.update(compare_q3i_split_sb(ms, dev))
    int8_io_err = compare_int8_io(ms, im, dev)
    gemm_err = compare_int8_gemm(im, dev)
    flash_err = compare_flash(fa, dev)
    fused_err = compare_fused(ms, dev)
    tp_err = compare_tp(ms, dev)
    v2_err = compare_v2(ms, dev)
    variant_err = compare_q3i_variants(ms, dev)
    probe_err = compare_probe_shapes(ms, dev)
    v2_err = max(v2_err, probe_err["fused_mha_short_v2"])
    fused_err["fused_mha_short"] = max(fused_err["fused_mha_short"], probe_err["fused_mha_short"])
    variant_err = {v: max(e, probe_err[v]) for v, e in variant_err.items()}
    norm_err = compare_normalize(pp, dev)
    backward_err = compare_backward(ms, fa, dev)
    probe_inputs = _probe_inputs(dev)
    gemm_probe_err = compare_gemm_probes(gp, probe_inputs)
    tower_err = compare_tower_bf16(tb, dev)

    print("phase 4: timing (CUDA events over 20 calls queued behind a device spin, after 3 "
          "warm-up; plain, kernel, kernel, plain)")
    times = time_kernel(ms, dev)
    times.update(time_q3i(ms, dev))
    times.update(time_int8_io(ms, im, dev))
    times.update(time_int8_gemm(im, quant, dev))
    flash_times = time_flash(fa, dev)
    times.update(time_fused(ms, dev))
    times.update(time_tp(ms, dev))
    times.update(time_probe_kernels(ms, pp, dev))
    times.update(time_gemm_probes(gp, probe_inputs))
    del probe_inputs
    times.update(time_tower_bf16(tb, dev))
    report_redesign(times, flash_times)
    report_gemm_redesign(times)
    report_int8_attention_redesign(times)
    report_last_redesigns(times)

    print("phase 5: main paths")
    with tempfile.TemporaryDirectory() as log_dir:
        counts = run_main_path(ms, log_dir)
        int8 = run_int8_path(ms, log_dir, os.path.join(log_dir, "int8_cache"))
        routes = run_int8_routes(ms, im, log_dir, os.path.join(log_dir, "int8_route_caches"))
        dynamic = run_int8_dynamic_tiers(ms, im, log_dir, os.path.join(log_dir, "int8_tier_caches"))
        proof = run_proof_path(ms, fa, log_dir)
        proof.update(time_first_optimizer())
        fused = run_fused_paths(ms, fa, log_dir)
        siglip = run_siglip_path(fa, tb, dev)
        vitb16_bf16 = run_vitb16_bf16_path(tb)
        print("  Grad-CAM through the kernels' backwards, checkpoint/resume, the full protocol")
        gradcam = check_gradcam(ms, fa, dev)
        resume = run_resume(log_dir)
        protocol = run_full_protocol()
        parallel = run_parallel_paths(ms, log_dir)
        probes = run_probe_paths(ms, pp, dev)
        gemm_probes = run_gemm_probe_paths(gp)
        print("  the repairs: bicubic resize (fault 3.2), the open_clip loader (fault 3.8)")
        resize_err = check_resize(pp, dev)
        loader = check_loader(log_dir)
        print("phase 6: features and encode rates")
        rates, int8_runtimes, short_launches, served, tiers, text = check_features(
            im, dev, os.path.join(log_dir, "int8_cache"), os.path.join(log_dir, "int8_route_caches"))
    for tier, before in MMA_SYNC_TIER_RATES.items():
        print(f"  encode int8 {tier}: {tiers[tier]['rate']:.1f} img/s against {before:,.1f} with #21 "
              f"on mma.sync (PERF.md §5), {tiers[tier]['rate'] / before:.3f}x")
    for tier, (low, high) in GEMM_MMA_SYNC_TIER_RATES.items():
        print(f"  encode int8 {tier}: {tiers[tier]['rate']:.1f} img/s against {low:,.1f}-{high:,.1f} "
              f"with #15 and #20 on mma.sync (PERF.md §7), {tiers[tier]['rate'] / high:.3f}x its "
              "high end")
    for key, before in INT8_CUDA_CORE_RATES.items():
        print(f"  encode {key}: {rates[key]:.1f} img/s against {before:,.1f} with the int8 "
              f"attention on the CUDA cores (PERF.md §5), {rates[key] / before:.3f}x")
    print("phase 7: profile of one encode")
    profile_encodes(int8_runtimes, tiers["pallas"]["encode"], dev)

    def timing(t):
        return {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}

    q3i_common = {"route": "cuda", "source": "team_tpu_torch/csrc/mha_packed_q3i.cu"}
    probe_common = {"route": "cuda", "source": "team_tpu_torch/csrc/gemm_probe.cu"}
    q_common = {"route": "cuda", "source": "team_tpu_torch/csrc/mha_packed_q.cu"}
    quant_common = {"route": "cuda", "source": "team_tpu_torch/csrc/int8_quant.cu"}
    tower_common = {"route": "cuda", "source": "team_tpu_torch/csrc/tower_bf16.cu",
                    "replaces": "none: the composition of backbone/clip.py (team_tpu leaves it "
                                "to XLA's fusions)",
                    "launches_per_b128_encode": {"vitb16": vitb16_bf16["launches"],
                                                 "siglip": siglip["tower_bf16_launches"]},
                    "features_cos_composition_min": vitb16_bf16["cos_composition_min"]}
    gemm_common = {"route": "cuda", "source": "team_tpu_torch/csrc/int8_gemm.cu",
                   "library": "torch._int_mm alone (the int8 product only)",
                   "composition": "the xla tier's torch composition of the same step"}

    def gemm_timing(t):
        return {**timing(t), "composition_ms": t["composition_ms"]}

    def fused_timing(t):
        return {**timing(t), "tflops": t["tflops"], "bound_share": t["bound_share"]}

    def tier_launches(name):
        return sum(r["launches"][name] for r in dynamic.values())

    tier_gates = {tier: {"gate_cosine": r["gate_cosine"], "committed": r["committed"],
                         "int8_batches": r["int8_batches"]} for tier, r in dynamic.items()}

    def route_launches(name):
        return sum(r["launches"][name] for r in routes.values())

    def route_cosines(*names):
        return {n: routes[n]["gate_cosine"] for n in names}

    def fused_launches(key):
        return sum(r["launches"][key] for r in fused.values())

    def fused_rates(route):
        return {k: v for k, v in rates.items() if k.endswith(route)}

    def backward(name, route, vjp):
        return {"rule": f"torch.autograd.Function: the kernel's forward; the backward recomputes "
                        f"{vjp} and differentiates it (team_tpu's custom VJP), no backward kernel",
                "max_rel_err": backward_err[name], "tol": BACKWARD_TOL,
                "gradcam": gradcam[route]}

    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "fused_mha_packed", "route": "cuda",
        "source": "team_tpu_torch/csrc/mha_packed.cu",
        "replaces": "team_tpu/ops/mha_short.py:135",
        "launches": counts["launches"], "causal_launches": counts["causal"],
        "max_abs_err": max_err, **timing(times["vision"]),
        "text": timing(times["text"]), "encode_img_per_s": rates,
        "hmma_per_kernel": hmma["mha_packed.cu"],
        "backward": backward("fused_mha_packed", "auto",
                             "xla_attention in the packed layout (mha_packed_backward_reference)"),
        "full_protocol_proof_bf16": protocol, "resume": resume,
    }, {
        "name": "fused_mha_packed_q3i", **q3i_common,
        "replaces": "team_tpu/ops/mha_short.py:477",
        "launches": int8["q3i"], "max_abs_err": q3i_err["q3i"], **timing(times["q3i"]),
        "gate_cosine": int8["gate_cosine"],
        "imma_per_kernel": imma["mha_packed_q3i.cu"], "hmma_per_kernel": hmma["mha_packed_q3i.cu"],
    }, {
        "name": "fused_mha_packed_q3i_cls", **q3i_common,
        "replaces": "team_tpu/ops/mha_short.py:663",
        "launches": int8["q3i_cls"], "max_abs_err": q3i_err["q3i_cls"], **timing(times["q3i_cls"]),
        "kernel": "q3i_cls_kernel (cp.async staging, every warp computes)",
    }, {
        "name": "fused_mha_packed_q3i_cls_split", **q3i_common,
        "replaces": "team_tpu/ops/mha_short.py:763",
        "launches": route_launches("fused_mha_packed_q3i_cls_split"),
        "max_abs_err": q3i_err["q3i_cls_split"], "equals_q3i_cls": True,
        **timing(times["q3i_cls_split"]), "gate_cosine": route_cosines("kqs"),
    }, {
        "name": "fused_mha_packed_q3i_sb", **q3i_common,
        "replaces": "team_tpu/ops/mha_short.py:862",
        "launches": route_launches("fused_mha_packed_q3i_sb"),
        "max_abs_err": q3i_err["q3i_sb"], **timing(times["q3i_sb"]),
        "gate_cosine": route_cosines("static3d_qis"),
    }, *({
        "name": f"fused_mha_packed_q3i[{mode}]", **q3i_common,
        "replaces": "team_tpu/ops/mha_short.py:477",
        "launches": served[MODE_SERVED[mode]]["fused_mha_packed_q3i"],
        "launches_from": f"phase 6 encode on {MODE_SERVED[mode]}",
        "max_abs_err": q3i_err[mode], **timing(times[f"q3i[{mode}]"]),
    } for mode in Q3I_MODES), {
        "name": "fused_mha_packed_q", **q_common, "replaces": "team_tpu/ops/mha_short.py:308",
        "launches": route_launches("fused_mha_packed_q"),
        "max_abs_err": int8_io_err["fused_mha_packed_q"], **timing(times["fused_mha_packed_q"]),
        "gate_cosine": route_cosines("static_qa"), "hmma_per_kernel": hmma["mha_packed_q.cu"],
    }, {
        "name": "fused_mha_packed_q3", **q_common, "replaces": "team_tpu/ops/mha_short.py:395",
        "launches": route_launches("fused_mha_packed_q3"),
        "max_abs_err": int8_io_err["fused_mha_packed_q3"], **timing(times["fused_mha_packed_q3"]),
        "gate_cosine": route_cosines("static3d_qaf"),
    }, {
        "name": "ln_quantize_static", **quant_common,
        "replaces": "team_tpu/ops/int8_matmul.py:371",
        "launches": route_launches("ln_quantize_static"),
        "max_abs_err": int8_io_err["ln_quantize_static"], **timing(times["ln_quantize_static"]),
        "gate_cosine": route_cosines("static_qa", "static"),
        "static3_entry": "ln_quantize_static3 (team_tpu/ops/int8_matmul.py:416): this kernel on "
                         "the [B*S, D] view, bit for bit ln_quantize_static (phase 3); no route "
                         "calls it",
    }, {
        "name": "ln_quantize", **quant_common, "replaces": "team_tpu/ops/int8_matmul.py:324",
        "launches": tier_launches("ln_quantize"), "launches_from": "phase 5 simplecil on hybrid "
        "and pallas (gate batch)", "max_abs_err": gemm_err["ln_quantize"],
        **timing(times["ln_quantize"]), "composition_ms": times["ln_quantize"]["composition_ms"],
        "composition": "quant._ln_quant_rows (the xla tier's layer norm and quantize_rows)",
        "gate": tier_gates,
    }, {
        "name": "int8_linear", **gemm_common, "replaces": "team_tpu/ops/int8_matmul.py:54",
        "entries": "int8_linear, int8_linear_nk (bit for bit), int8_linear_kgrid, "
                   "int8_linear_wres, int8_linear_dma, quantized_linear",
        "launches": tier_launches("int8_linear"), "launches_from": "phase 5 simplecil on pallas "
        "(gate batch)", "max_abs_err": gemm_err["int8_linear"],
        **gemm_timing(times["int8_linear qkv"]), "mma_sync_ms": times["int8_linear qkv"]["mma_sync_ms"],
        "out": {**gemm_timing(times["int8_linear out"]),
                "mma_sync_ms": times["int8_linear out"]["mma_sync_ms"]},
        "kernel": "gemm_kernel_wg (wgmma + TMA, csrc/wgmma_gemm.cuh) at every shape; "
                  "gemm_kernel (mma.sync) behind int8_linear_mma, equal bit for bit (phase 3)",
        "gmma_per_kernel": gmma["int8_gemm.cu"],
        "encode_img_per_s": {tier: t["rate"] for tier, t in tiers.items()},
        "features_cos_bf16": {tier: t["cos_bf16"] for tier, t in tiers.items()},
        "text_tower": text,
    }, {
        "name": "int8_linear_gelu_quant", **gemm_common,
        "replaces": "team_tpu/ops/int8_matmul.py:490",
        "launches": tier_launches("int8_linear_gelu_quant"), "launches_from": "phase 5 simplecil "
        "on hybrid and pallas (gate batch)", "max_abs_err": gemm_err["int8_linear_gelu_quant"],
        **gemm_timing(times["int8_linear_gelu_quant fc"]),
        "kernel": "gelu_quant_kernel_wg (wgmma + TMA, csrc/wgmma_gemm.cuh) at bn 256 and 512, "
                  "gelu_quant_kernel (mma.sync) at other bn; equal bit for bit (phase 3)",
        "mma_sync_ms": times["int8_linear_gelu_quant fc"]["mma_sync_ms"],
        "gmma_per_kernel": gmma["int8_gemm.cu"],
    }, {
        "name": "int8_linear_blockscale", **gemm_common,
        "replaces": "team_tpu/ops/int8_matmul.py:565",
        "launches": tier_launches("int8_linear_blockscale"), "launches_from": "phase 5 simplecil "
        "on hybrid and pallas (gate batch)", "max_abs_err": gemm_err["int8_linear_blockscale"],
        **gemm_timing(times["int8_linear_blockscale proj"]),
        "mma_sync_ms": times["int8_linear_blockscale proj"]["mma_sync_ms"],
        "kernel": "blockscale_kernel_wg (wgmma + TMA, csrc/wgmma_gemm.cuh) at bk a multiple of "
                  "128, gemm_kernel (mma.sync) at other bk; equal bit for bit (phase 3)",
        "gmma_per_kernel": gmma["int8_gemm.cu"],
    }, {
        "name": "row_quant_static", **quant_common,
        "replaces": "team_tpu/ops/int8_matmul.py:458",
        "launches": route_launches("row_quant_static"),
        "max_abs_err": int8_io_err["row_quant_static"], **timing(times["row_quant_static"]),
        "gate_cosine": route_cosines("static"),
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "team_tpu_torch/csrc/flash_attention.cu",
        "replaces": "team_tpu/ops/flash_attention.py:35",
        "launches": proof["flash"], "causal_launches": proof["causal"],
        "max_abs_err": flash_err, **timing(flash_times["vision"]),
        "text": timing(flash_times["text"]), "siglip": timing(flash_times["siglip"]),
        "siglip_encode": siglip, "hmma_per_kernel": hmma["flash_attention.cu"],
        "proof_wall_s": proof["wall_s"],
        "proof_step_ms": proof["step_ms"], "proof_step_device_ms": proof["step_device_ms"],
        "proof_loss_rel_diff": proof["loss_rel_diff"], "import_dynamo_s": proof["import_dynamo_s"],
        "backward": backward("flash_attention", "pallas", "xla_attention"),
    }, {
        "name": "fused_mha_short", "route": "cuda", "source": "team_tpu_torch/csrc/mha_packed.cu",
        "replaces": "team_tpu/ops/mha_short.py:35",
        "launches": short_launches, "launches_from": "phase 6 image-tower encodes on mha_short",
        "max_abs_err": fused_err["fused_mha_short"], **timing(times["fused_mha_short vision bf16"]),
        "encode_img_per_s": fused_rates("mha_short"),
        "backward": backward("fused_mha_short", "mha_short", "xla_attention, non-causal"),
    }, {
        "name": "fused_mha_packed_proj", "route": "cuda",
        "source": "team_tpu_torch/csrc/attn_block.cu", "replaces": "team_tpu/ops/mha_short.py:985",
        "launches": fused_launches("mha_packed_proj"),
        "causal_launches": fused_launches("mha_packed_proj_causal"),
        "max_abs_err": fused_err["fused_mha_packed_proj"],
        **fused_timing(times["fused_mha_packed_proj vision bf16"]),
        "library": "composition: scaled_dot_product_attention + addmm + add",
        "f32": fused_timing(times["fused_mha_packed_proj vision f32"]),
        "text": fused_timing(times["fused_mha_packed_proj text bf16"]),
        "hmma_per_kernel": hmma["attn_block.cu"],
        "encode_img_per_s": fused_rates("mha_packed_proj"),
    }, {
        "name": "fused_attn_block", "route": "cuda", "source": "team_tpu_torch/csrc/attn_block.cu",
        "replaces": "team_tpu/ops/mha_short.py:935",
        "launches": fused_launches("attn_block"), "causal_launches": fused_launches("attn_block_causal"),
        "kernel_launches": fused_launches("attn_block") + fused_launches("attn_block_proj"),
        "max_abs_err": fused_err["fused_attn_block"],
        **fused_timing(times["fused_attn_block vision bf16"]),
        "library": "composition: layer_norm + addmm + scaled_dot_product_attention + addmm + add",
        "f32": fused_timing(times["fused_attn_block vision f32"]),
        "text": fused_timing(times["fused_attn_block text bf16"]),
        "encode_img_per_s": fused_rates("attn_block"),
        "runs_wall_s": {k: r["wall_s"] for k, r in fused.items()},
        "backward": backward("fused_attn_block", "attn_block",
                             "the layer norm, qkv, xla_attention, out-projection and residual "
                             "(attn_block_backward_reference)"),
    }, {
        "name": "fused_mha_packed_tp", "route": "cuda", "source": "team_tpu_torch/csrc/mha_packed.cu",
        "replaces": "team_tpu/ops/mha_short.py:1241",
        "launches": parallel["launches"]["fused_mha_packed_tp"],
        "launches_per_rank": parallel["per_rank"]["fused_mha_packed_tp"],
        "launches_from": f"phase 5, {PARALLEL_WORLD} ranks on one card: the bf16 tower and the "
                         "int8 tier's calibration under a [1, 2] layout",
        "max_abs_err": tp_err["fused_mha_packed_tp"], "equals_fused_mha_packed": True,
        "per_rank_launch": "nm=2, rank 0", **timing(times["tp vision nm=2"]),
        "nm4": timing(times["tp vision nm=4"]), "text": timing(times["tp text nm=2"]),
        "library": "scaled_dot_product_attention on the rank's head views",
        "tp_features_cos": parallel["tp_cosine"],
    }, {
        "name": "fused_mha_packed_q3i_tp", **q3i_common,
        "replaces": "team_tpu/ops/mha_short.py:1294",
        "launches": parallel["launches"]["fused_mha_packed_q3i_tp"],
        "launches_per_rank": parallel["per_rank"]["fused_mha_packed_q3i_tp"],
        "launches_from": f"phase 5, {PARALLEL_WORLD} ranks on one card: the int8 static3d_qi "
                         "tower under a [1, 2] layout (gate batch and one committed encode)",
        "max_abs_err": tp_err["fused_mha_packed_q3i_tp"], "equals_fused_mha_packed_q3i": True,
        "per_rank_launch": "nm=2, rank 0", **timing(times["q3i_tp vision nm=2"]),
        "nm4": timing(times["q3i_tp vision nm=4"]), "gate": parallel["gate"],
        "parallel_wall_s": parallel["wall_s"], "dp_proof_wall_s": parallel["dp_wall_s"],
        "dp_grad_err": parallel["dp_grad_err"],
    }, {
        "name": "fused_mha_short_v2", "route": "cuda", "source": "team_tpu_torch/csrc/mha_packed.cu",
        "replaces": "team_tpu/ops/mha_short.py:62",
        "launches": probes["v2_launches"],
        "launches_from": "phase 5, team_tpu_torch.scripts.attn_shootout (MODE all and qpad128)",
        "max_abs_err": v2_err, **timing(times["v2 f32exp"]), "bf16exp": timing(times["v2 bf16exp"]),
        "kernel": "mha_v2_kernel_tc (bf16: CUDA-core logits in head-dimension order, PV on "
                  "mma.sync; f32 and fused_mha_short_v2_cuda_core on mha_packed_kernel)",
        "cuda_core_ms": times["v2 f32exp"]["cuda_core_ms"],
        "bf16exp_cuda_core_ms": times["v2 bf16exp"]["cuda_core_ms"],
        "hmma_per_kernel": hmma["mha_packed.cu"],
        "shootout_ms_per_layer": probes["shootout"],
    }, *({
        "name": f"fused_mha_q3i_variant[{variant}]", **q3i_common,
        "replaces": "scripts/r4_attn_decomp.py:43",
        "launches": probes["variant_launches"][variant],
        "launches_from": "phase 5, team_tpu_torch.scripts.r4_attn_decomp",
        "max_abs_err": variant_err[variant], **timing(times[f"variant {variant}"]),
        "decomp_ms_per_layer": probes["decomp"][variant],
    } for variant in ms.Q3I_VARIANTS), {
        "name": "normalize_uint8_kernel", "route": "cuda",
        "source": "team_tpu_torch/csrc/preprocess.cu", "replaces": "team_tpu/ops/preprocess.py:60",
        "launches": probes["normalize_launches"], "launches_from": "phase 5, the library API",
        "max_abs_err": norm_err, **timing(times["normalize_uint8"]),
        "composition_ms": times["normalize_uint8"]["composition_ms"],
        "composition": "(x.float() / 255 - mean) / std",
        "resize_card_vs_cpu_max_abs": resize_err, "loader": loader,
    }, {
        "name": "probe_mm", **probe_common, "replaces": "scripts/int8_probe.py:48",
        "launches": gemm_probes["int8_probe_launches"]["probe_mm"],
        "launches_from": "phase 5, team_tpu_torch.scripts.int8_probe",
        "max_abs_err": gemm_probe_err["probe_mm int8"], **timing(times["probe_mm int8"]),
        "tops": times["probe_mm int8"]["tops"], "library": "torch._int_mm",
        "kernel": "probe_mm_kernel_wg_s8 (wgmma + TMA, csrc/wgmma_gemm.cuh)",
        "bf16": {**timing(times["probe_mm bf16"]), "tops": times["probe_mm bf16"]["tops"],
                 "max_abs_err": gemm_probe_err["probe_mm bf16"],
                 "library": "torch.matmul on the bf16 operands (bf16 out)",
                 "kernel": "probe_mm_kernel_wg (wgmma + TMA, csrc/wgmma_gemm.cuh)"},
        "gmma_per_kernel": gmma["gemm_probe.cu"],
        "probe": gemm_probes["int8_probe"],
    }, {
        "name": "mxu_ceiling", **probe_common, "replaces": "scripts/int8_mxu_ceiling.py:50",
        "launches": gemm_probes["int8_mxu_ceiling_launches"]["mxu_ceiling"],
        "launches_from": "phase 5, team_tpu_torch.scripts.int8_mxu_ceiling",
        "max_abs_err": gemm_probe_err["mxu_ceiling int8"], **timing(times["mxu_ceiling int8"]),
        "tops": times["mxu_ceiling int8"]["tops"],
        "peak_share": times["mxu_ceiling int8"]["peak_share"], "label": "the wgmma ceiling",
        "kernel": "ceiling_kernel_wg (wgmma + TMA, csrc/wgmma_gemm.cuh; 128 x 256 tiles, one "
                  "CTA an SM over a range of the products; ceiling_reduce_kernel adds the "
                  "ranges in order)",
        "bf16": {**timing(times["mxu_ceiling bf16"]), "tops": times["mxu_ceiling bf16"]["tops"],
                 "peak_share": times["mxu_ceiling bf16"]["peak_share"],
                 "max_abs_err": gemm_probe_err["mxu_ceiling bf16"]},
        "probe": gemm_probes["int8_mxu_ceiling"],
    }, {
        "name": "mlp_mega", **probe_common, "replaces": "scripts/r5_megakernel_probe.py:73",
        "entries": "mlp_mega_2d, mlp_mega_3d (r5_megakernel_probe.py:105; bit for bit)",
        "launches": sum(gemm_probes["r5_megakernel_probe_launches"].values()),
        "launches_by_entry": gemm_probes["r5_megakernel_probe_launches"],
        "launches_from": "phase 5, team_tpu_torch.scripts.r5_megakernel_probe",
        "max_abs_err": gemm_probe_err["mlp_mega"],
        "rows_differing": gemm_probe_err["mlp_mega rows differing"], **timing(times["mlp_mega"]),
        "tops": times["mlp_mega"]["tops"], "library": "the torch composition (xla_pair)",
        "kernel": "mlp_mega_kernel_wg (wgmma + TMA, hq resident in shared memory, 2-CTA "
                  "clusters multicasting the weights)",
        "probe_ms_per_pair": gemm_probes["r5_megakernel_probe"],
    }, {
        "name": "bias_act", **tower_common, "bit_equal": True,
        **timing(times["bias_act vitb16 fc"]), "siglip": timing(times["bias_act siglip fc"]),
    }, {
        "name": "residual_ln", **tower_common, "ln_differing_share": tower_err["residual_ln"],
        **timing(times["residual_ln vitb16"]), "siglip": timing(times["residual_ln siglip"]),
    }, {
        "name": "layer_norm", **tower_common, "differing_share": tower_err["layer_norm"],
        "library": "F.layer_norm with gamma and beta rounded to bf16 (speed only)",
        **timing(times["layer_norm vitb16"]), "siglip": timing(times["layer_norm siglip"]),
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-worker"]:  # one rank of phase 5's parallel paths
        sys.exit(parallel_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
    if sys.argv[1:2] == ["--full-protocol"]:  # phase 5's ten-task PROOF run
        sys.exit(full_protocol_worker())
    sys.exit(main())
