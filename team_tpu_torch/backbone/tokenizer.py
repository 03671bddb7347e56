"""The CLIP tokenizer of ``team_tpu/backbone/tokenizer.py``, loaded by path
(``team_tpu/backbone/__init__.py`` imports jax)."""

from team_tpu_torch._reuse import load_team_tpu_file

_mod = load_team_tpu_file("backbone/tokenizer.py")
Tokenizer = _mod.Tokenizer
