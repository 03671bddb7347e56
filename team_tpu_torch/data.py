"""The data layer: ``team_tpu.data`` (task splits, datasets, the threaded
loader, the native decoder) is framework-free, so the port uses it as it is.
Batches arrive as numpy arrays and the learners move them to the device."""

from team_tpu.data.loader import ArrayLoader  # noqa: F401
from team_tpu.data.manager import DataManager  # noqa: F401
