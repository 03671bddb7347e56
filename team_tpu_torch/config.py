"""The configuration surface: ``team_tpu.config`` is framework-free, so the
port uses it as it is (the same JSON experiment schema and defaults)."""

from team_tpu.config import Config, load_config  # noqa: F401
