"""Probe entry points of the port: counterparts of the repository's
``scripts/`` probes that drive kernels no runtime path calls.

    python -m team_tpu_torch.scripts.attn_shootout     # on the card
    python -m team_tpu_torch.scripts.r4_attn_decomp --device cpu --batch 2 --layers 2
"""
