"""Entry points of the port beside the CLI: counterparts of the repository's
``scripts/`` probes that drive kernels no runtime path calls, and of its
full-protocol runner.

    python -m team_tpu_torch.scripts.attn_shootout     # on the card
    python -m team_tpu_torch.scripts.r4_attn_decomp --device cpu --batch 2 --layers 2
    python -m team_tpu_torch.scripts.int8_probe        # the GEMM probes, on the card
    python -m team_tpu_torch.scripts.int8_mxu_ceiling
    python -m team_tpu_torch.scripts.r5_megakernel_probe
    python -m team_tpu_torch.scripts.full_protocol      # TEAM_MODEL, TEAM_ENCODER_QUANT, TEAM_PIN
"""
