"""What the compiled kernels of ``team_tpu_torch/csrc/`` must issue, by name.

The card tests (``tests/test_torch_cuda.py``) count these opcodes in each
kernel's SASS (``cuobjdump -sass``) and read ptxas's report of each source;
``tests/test_torch_kernel_names.py`` checks on the CPU that every name here
is a ``__global__`` function of its source, so that no check passes on a
name that a redesign renamed away. A name is matched as a part of the
mangled name; a tensor-core name (``*_tc``, ``*_wg``) holds its CUDA-core or
``mma.sync`` kernel's name, so it is matched first.
"""

# the attention sources whose bf16 kernels run on the tensor cores (mma.sync;
# #4's bf16 kernel its PV alone) and whose f32 kernels run on the CUDA cores:
# source -> (kernels that issue HMMA, kernels that issue none)
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
# kernels, mma.sync kernels)
GMMA_SOURCES = {
    "int8_gemm.cu": (("gelu_quant_kernel_wg", "gemm_kernel_wg", "blockscale_kernel_wg"),
                     ("gelu_quant_kernel", "gemm_kernel")),
    "gemm_probe.cu": (("probe_mm_kernel_wg_s8", "probe_mm_kernel_wg", "mlp_mega_kernel_wg",
                       "ceiling_kernel_wg"), ()),
}

# the GMMA forms each wgmma kernel issues, as cuobjdump prints them: each
# instantiation issues one of them, and each is issued (the s8 m64n256 forms
# of #15, #21, #27 and #28, #20's and #30's m64n128, #27's and #28's bf16)
GMMA_MNEMONICS = {
    "gelu_quant_kernel_wg": ("IGMMA.64x256x32.S8.S8",),
    "gemm_kernel_wg": ("IGMMA.64x256x32.S8.S8",),
    "blockscale_kernel_wg": ("IGMMA.64x128x32.S8.S8",),
    "probe_mm_kernel_wg": ("HGMMA.64x256x16.F32.BF16",),
    "probe_mm_kernel_wg_s8": ("IGMMA.64x256x32.S8.S8",),
    "mlp_mega_kernel_wg": ("IGMMA.64x128x32.S8.S8",),
    "ceiling_kernel_wg": ("HGMMA.64x256x16.F32.BF16", "IGMMA.64x256x32.S8.S8"),
}

# the instantiations each kernel has, so that a dropped or added one shows
INSTANCES = {
    # bf16 #1-#3: dh 32 and 64 at windows of 8, 13 and 16 blocks, dh 128 at 8
    "mha_packed_kernel_tc": 7,
    # f32 #1-#4: 3 head widths x (no switch, #4's deferred normalise with the
    # f32 and with the bf16 exponential)
    "mha_packed_kernel": 9,
    # #4's bf16 kernel: dh 32 and 64 at windows of 4, 7 and 8 blocks, dh 128
    # at 4, each with the f32 and the bf16 exponential
    "mha_v2_kernel_tc": 14,
    # bf16: dh 32, 64 and SigLIP's 72; f32: dh 32 and 64
    "flash_kernel_tc": 3,
    "flash_kernel": 2,
    # 3 head widths x (5 normalisations x 2 softmaxes + the probe's noexp),
    # and the probe's qkonly and nopv at 3 head widths
    "q3i_kernel_tc": 39,
    "q3i_cls_kernel": 3,
    # 2 dequants x 3 logits windows
    "mha_q_kernel_tc": 6,
    "gelu_quant_kernel_wg": 2,
    "gemm_kernel_wg": 4,
    "blockscale_kernel_wg": 2,
    # gelu_quant at bn other than 256 and 512; blockscale at bk no multiple
    # of 128 (bf16 and f32 out)
    "gelu_quant_kernel": 1,
    "gemm_kernel": 2,
    "probe_mm_kernel_wg": 1,
    "probe_mm_kernel_wg_s8": 1,
    "mlp_mega_kernel_wg": 1,
    "ceiling_kernel_wg": 2,
}

# the CUDA-core kernels redesigned for their bytes, which may not spill
# either: source -> kernels (#8/#9's CLS kernel)
NO_SPILL_CUDA_CORE = {"mha_packed_q3i.cu": ("q3i_cls_kernel",)}
