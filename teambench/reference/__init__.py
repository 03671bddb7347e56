"""The plain PyTorch reference of the benchmark's cells.

It imports nothing of ``team_tpu_torch``, ``team_tpu`` or ``jax`` and takes
nothing the program made: it gets the benchmark's own weights and inputs and
works out again every cast, calibration and quantized payload.
"""
