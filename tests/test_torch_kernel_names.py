"""The kernel names that ``chip_smoke.py`` phase 2 checks in the SASS: every
name of its ``TC_SOURCES`` (HMMA) and ``GMMA_SOURCES`` (wgmma) tables is a
``__global__`` function of the named ``team_tpu_torch/csrc/`` source, so
that no check passes on a name that a redesign renamed away. The tables are
read from the script's source (importing it would set its environment), and
the CUDA sources are read as text: nothing here needs a card or ``nvcc``."""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "team_tpu_torch" / "csrc"


def _tables() -> dict:
    """chip_smoke.py's SASS tables by name: source -> (kernels that issue the
    opcode, kernels that issue none)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    tables = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            name = getattr(node.targets[0], "id", None)
            if name in ("TC_SOURCES", "GMMA_SOURCES"):
                tables[name] = ast.literal_eval(node.value)
    return tables


TABLES = _tables()
CASES = [(table, source, kernel, role)
         for table, sources in sorted(TABLES.items())
         for source, (issuing, other) in sorted(sources.items())
         for role, kernels in (("issues", issuing), ("issues none", other))
         for kernel in kernels]


def _global_functions(source: str) -> set:
    """The names of the ``__global__`` functions that a CUDA source defines."""
    text = (CSRC / source).read_text()
    text = re.sub(r"//[^\n]*", "", text)  # comments may name kernels too
    text = re.sub(r"__launch_bounds__\((?:[^()]|\([^()]*\))*\)", "", text)
    return set(re.findall(r"__global__\s+void\s+(\w+)\s*\(", text))


def test_both_tables_are_read():
    assert set(TABLES) == {"TC_SOURCES", "GMMA_SOURCES"}
    assert all(issuing and isinstance(other, tuple)
               for sources in TABLES.values() for issuing, other in sources.values())


@pytest.mark.parametrize("table,source,kernel,role", CASES,
                         ids=[f"{t}-{s}-{k}" for t, s, k, _ in CASES])
def test_every_checked_name_is_a_kernel_of_its_source(table, source, kernel, role):
    assert (CSRC / source).is_file(), f"{table} names {source}, which is not in {CSRC}"
    kernels = _global_functions(source)
    assert kernel in kernels, f"{table}: {kernel} ({role}) is no __global__ function of " \
                              f"{source}; it has {sorted(kernels)}"


def test_the_redesigned_kernels_are_checked():
    """#4's bf16 kernel is checked for HMMA and #27's int8 kernel for GMMA."""
    assert "mha_v2_kernel_tc" in TABLES["TC_SOURCES"]["mha_packed.cu"][0]
    assert "probe_mm_kernel_wg_s8" in TABLES["GMMA_SOURCES"]["gemm_probe.cu"][0]
