"""Load framework-free ``team_tpu`` files by path.

``team_tpu/backbone/__init__.py`` and ``team_tpu/utils/__init__.py`` import
jax, so their jax-free files (the tokenizer, the phase timer) cannot be
imported through the package without pulling jax in. This loads one such file
as a module of its own, without running the package's ``__init__``.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from types import ModuleType


def load_team_tpu_file(relpath: str) -> ModuleType:
    """Load ``team_tpu/<relpath>`` (a file that imports no jax) as a module."""
    name = "team_tpu_torch._reused." + relpath.removesuffix(".py").replace("/", ".")
    if name in sys.modules:
        return sys.modules[name]
    pkg = importlib.util.find_spec("team_tpu")  # locates the package without importing it
    if pkg is None or not pkg.submodule_search_locations:
        raise ImportError("team_tpu package not found")
    path = Path(pkg.submodule_search_locations[0]) / relpath
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module
