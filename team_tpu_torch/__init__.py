"""TEAM on PyTorch and CUDA: the port of ``team_tpu`` to an NVIDIA H100.

``team_tpu`` (JAX, TPU) stays the reference. This package keeps its module
names, so ``team_tpu_torch.X`` is the counterpart of ``team_tpu.X``. It imports
``torch`` and never ``jax``: the framework-free parts of ``team_tpu`` are
reused as they are (``team_tpu.config``, ``team_tpu.data``), and the two
framework-free files that sit in packages whose ``__init__`` imports jax (the
tokenizer and the phase timer) are loaded by file path (:mod:`._reuse`).

The ported slice is the serving path: the frozen CLIP ViT-B/16 towers, whose
attention runs through the hand-written kernel ``csrc/mha_packed.cu``, and the
``simplecil`` and ``zs_clip`` learners behind ``python -m
team_tpu_torch.main``. What is still to port is listed in ROADMAP.md.
"""

__version__ = "0.1.0"
