"""The kernel names that ``chip_smoke.py`` phase 2 checks in the SASS: every
name of its ``TC_SOURCES`` (HMMA), ``GMMA_SOURCES`` (wgmma) and
``IMMA_SOURCES`` (s8 mma.sync) tables is a
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


def _tables(names=("TC_SOURCES", "GMMA_SOURCES", "IMMA_SOURCES")) -> dict:
    """chip_smoke.py's SASS tables by name: source -> (kernels that issue the
    opcode, kernels that issue none)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    tables = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            name = getattr(node.targets[0], "id", None)
            if name in names:
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
    assert set(TABLES) == {"TC_SOURCES", "GMMA_SOURCES", "IMMA_SOURCES"}
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
    """#4's bf16 kernel is checked for HMMA, #27's int8 kernel, #30's
    megakernel and #28's ceiling for GMMA (no mma.sync kernel is left in
    gemm_probe.cu); the int8
    attention's: #7's kernel (also #10, #11, #29) for IMMA and HMMA but for
    the 6 instantiations of #29's qkonly and nopv, which run no PV, #5/#6's
    for HMMA, and the CLS kernel (#8, #9) for neither."""
    assert "mha_v2_kernel_tc" in TABLES["TC_SOURCES"]["mha_packed.cu"][0]
    assert TABLES["GMMA_SOURCES"]["gemm_probe.cu"] == (
        ("probe_mm_kernel_wg_s8", "probe_mm_kernel_wg", "mlp_mega_kernel_wg", "ceiling_kernel_wg"),
        ())
    assert TABLES["TC_SOURCES"]["mha_packed_q3i.cu"] == (("q3i_kernel_tc",), ("q3i_cls_kernel",))
    assert TABLES["IMMA_SOURCES"]["mha_packed_q3i.cu"] == (("q3i_kernel_tc",), ("q3i_cls_kernel",))
    assert _tables(("NO_PV_INSTANCES",))["NO_PV_INSTANCES"] == {
        "mha_packed_q3i.cu": {"q3i_kernel_tc": 6}}
    assert "mha_q_kernel_tc" in TABLES["TC_SOURCES"]["mha_packed_q.cu"][0]


def test_no_pv_instances_are_the_probe_cuts_of_a_tensor_core_kernel():
    """Phase 2 lets exactly ``NO_PV_INSTANCES`` instantiations of a tensor-core
    kernel issue no HMMA: each named kernel is a tensor-core kernel of
    ``TC_SOURCES`` and a ``__global__`` function of its source, and its count
    is the source's launches of the variants without PV (VAR kQkOnly and
    kNoPv) times the head widths its launcher takes."""
    no_pv = _tables(("NO_PV_INSTANCES",))["NO_PV_INSTANCES"]
    for source, kernels in no_pv.items():
        text = (CSRC / source).read_text()
        launcher = text[text.index("int launch_dh(const Args& a) {"):]
        widths = re.findall(r"case (\d+): return launch_tc<", launcher[:launcher.index("\n}")])
        cuts = set(re.findall(r"launch_dh<kMxu, false, (kQkOnly|kNoPv)>", text))
        for kernel, n in kernels.items():
            assert kernel in TABLES["TC_SOURCES"][source][0], (source, kernel)
            assert kernel in _global_functions(source), (source, kernel)
            assert widths == ["32", "64", "128"] and cuts == {"kQkOnly", "kNoPv"}
            assert n == len(cuts) * len(widths), (kernel, n, cuts, widths)


def _family_patterns(prefixes=("gemm-", "attention-")) -> dict:
    """The benchmark's kernel families that claim GEMM or attention work: file
    name -> the name patterns that put a device kernel in it."""
    import json

    families = ROOT / "teambench" / "kernels"
    return {p.name: json.loads(p.read_text())["patterns"]
            for p in sorted(families.glob("*.json")) if p.name.startswith(prefixes)}


@pytest.mark.parametrize("kernel", sorted(_global_functions("int8_quant.cu")))
def test_the_quantize_and_epilogue_kernels_are_elementwise_work(kernel):
    """No kernel of ``int8_quant.cu`` (the producers and the static tower's
    epilogues) carries a pattern of a GEMM or attention family: the
    benchmark counts them as elementwise work, not in a roofline or in
    ``off_precision_share``."""
    families = _family_patterns()
    assert families, "no GEMM or attention family found"
    for name, patterns in families.items():
        assert not [p for p in patterns if p in kernel], (kernel, name)


@pytest.mark.parametrize("kernel", sorted(_global_functions("tower_bf16.cu")))
def test_the_bf16_tower_kernels_are_elementwise_work(kernel):
    """No kernel of ``tower_bf16.cu`` (bias and GELU, residual and layer norm,
    layer norm) carries a pattern of a GEMM or attention family: the
    benchmark books their time to ``tower.elementwise_ms``."""
    families = _family_patterns()
    assert families, "no GEMM or attention family found"
    for name, patterns in families.items():
        assert not [p for p in patterns if p in kernel], (kernel, name)


def test_the_bf16_tower_source_has_its_three_kernels():
    assert _global_functions("tower_bf16.cu") == {"bias_act_kernel", "residual_ln_kernel",
                                                   "layer_norm_kernel"}
