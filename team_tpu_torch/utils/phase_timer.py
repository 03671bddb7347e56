"""The wall-clock phase timer of ``team_tpu/utils/phase_timer.py``, loaded by
path (``team_tpu/utils/__init__.py`` imports jax). ``TEAM_PHASE_TIMES=1``
turns it on."""

from team_tpu_torch._reuse import load_team_tpu_file

_mod = load_team_tpu_file("utils/phase_timer.py")
phase = _mod.phase
format_report = _mod.format_report
reset = _mod.reset
