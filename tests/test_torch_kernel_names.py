"""The kernel names and launch entries that the card tests check: every name
of ``tests/sass_tables.py``'s ``TC_SOURCES`` (HMMA), ``GMMA_SOURCES``
(wgmma) and ``IMMA_SOURCES`` (s8 mma.sync) tables is a ``__global__``
function of the named ``team_tpu_torch/csrc/`` source, so that no check
passes on a name that a redesign renamed away; and every ``extern "C"``
launch entry of those sources is reached by a ``cuda``-marked test through
its Python wrapper, so that no kernel is left without a card check. The
CUDA sources, the wrappers and the card tests are read as text: nothing here
needs a card or ``nvcc``."""

import ast
import re
from pathlib import Path

import pytest

import sass_tables

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "team_tpu_torch" / "csrc"


def _tables(names=("TC_SOURCES", "GMMA_SOURCES", "IMMA_SOURCES")) -> dict:
    """The SASS tables by name: source -> (kernels that issue the opcode,
    kernels that issue none)."""
    return {name: getattr(sass_tables, name) for name in names}


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
    """The card tests let exactly ``NO_PV_INSTANCES`` instantiations of a
    tensor-core kernel issue no HMMA: each named kernel is a tensor-core kernel of
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


def test_the_other_tables_name_checked_kernels():
    """The instantiation counts, the GMMA forms and the CUDA-core kernels
    that may not spill name kernels of the three tables."""
    named = {k for sources in TABLES.values() for kernels in sources.values()
             for group in kernels for k in group}
    assert set(sass_tables.INSTANCES) <= named, set(sass_tables.INSTANCES) - named
    assert set(sass_tables.GMMA_MNEMONICS) == set(k for wg, _ in
                                                  sass_tables.GMMA_SOURCES.values() for k in wg)
    for source, kernels in sass_tables.NO_SPILL_CUDA_CORE.items():
        assert set(kernels) <= set(TABLES["TC_SOURCES"][source][1]), (source, kernels)


def _launch_entries() -> list:
    """(source, entry) for every ``extern "C"`` function of the CUDA sources
    that takes a stream: the launches, not the size queries."""
    entries = []
    for path in sorted(CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", path.read_text())
        for name, params in re.findall(r'extern "C"\s+int\s+(team_\w+)\s*\(([^)]*)\)', text):
            if re.search(r"void\s*\*\s*stream\s*$", params.strip()):
                entries.append((path.name, name))
    return entries


def _name(node) -> str:
    return node.id if isinstance(node, ast.Name) else getattr(node, "attr", "")


def _walk(tree):
    """``ast.walk`` without the bodies of ``with pytest.raises(...)``: a call
    that must raise reaches no kernel."""
    todo = [tree]
    while todo:
        node = todo.pop()
        yield node
        if isinstance(node, ast.With) and any("raises" in ast.unparse(item.context_expr)
                                              for item in node.items):
            todo.extend(item.context_expr for item in node.items)
            continue
        todo.extend(ast.iter_child_nodes(node))


def _called(tree) -> set:
    """The names that ``tree`` calls, and those listed in a ``for`` loop's
    tuple or list whose body calls the loop's variable (a test's loop over
    the functions that it calls)."""
    names = {_name(n.func) for n in _walk(tree) if isinstance(n, ast.Call)}
    for loop in _walk(tree):
        if not isinstance(loop, ast.For) or not isinstance(loop.iter, (ast.Tuple, ast.List)):
            continue
        calls = {_name(n.func) for stmt in loop.body for n in _walk(stmt)
                 if isinstance(n, ast.Call)}
        targets = loop.target.elts if isinstance(loop.target, ast.Tuple) else [loop.target]
        for i, target in enumerate(targets):
            if _name(target) not in calls:
                continue
            for item in loop.iter.elts:
                if target is loop.target:
                    names.add(_name(item))
                elif isinstance(item, ast.Tuple) and i < len(item.elts):
                    names.add(_name(item.elts[i]))
    return names - {""}


def _functions(tree: ast.Module) -> dict:
    """A module's top-level functions: name -> (source text, the names it
    calls)."""
    return {node.name: (ast.unparse(node), _called(node))
            for node in tree.body if isinstance(node, ast.FunctionDef)}


def _wrappers(entry: str) -> set:
    """The public functions of ``team_tpu_torch/ops`` through which ``entry``
    is launched: those that call it (as ``lib.<entry>(`` or by its name as a
    string; the functions that only declare its ``argtypes`` do not count),
    and every function that calls one of those, up to the public names."""
    found = set()
    called = re.compile(rf'\.{entry}\(|["\']{entry}["\']')
    for path in sorted((ROOT / "team_tpu_torch" / "ops").glob("*.py")):
        functions = _functions(ast.parse(path.read_text()))
        reach = {name for name, (text, _) in functions.items()
                 if called.search(text) and "argtypes" not in text}
        grown = True
        while grown:
            more = {name for name, (_, calls) in functions.items() if calls & reach} - reach
            reach |= more
            grown = bool(more)
        found |= {name for name in reach if not name.startswith("_")}
    return found


def _card_test_references() -> set:
    """The names that the ``cuda``-marked test modules call on the card: in
    each test function that takes the ``cuda_device`` fixture, and in the
    module's own functions that it calls, and those that they call."""
    names = set()
    for path in sorted(Path(__file__).parent.glob("test_*.py")):
        tree = ast.parse(path.read_text())
        marked = any(isinstance(node, ast.Assign)
                     and any(getattr(t, "id", None) == "pytestmark" for t in node.targets)
                     and ast.unparse(node.value) == "pytest.mark.cuda" for node in tree.body)
        if not marked:
            continue
        functions = {node.name: node for node in tree.body if isinstance(node, ast.FunctionDef)}
        todo = [node for name, node in functions.items() if name.startswith("test_")
                and "cuda_device" in [a.arg for a in node.args.args]]
        seen = set()
        while todo:
            node = todo.pop()
            if node.name in seen:
                continue
            seen.add(node.name)
            called = _called(node)
            names |= called
            todo.extend(functions[name] for name in called if name in functions)
    return names


ENTRIES = _launch_entries()
CARD_REFERENCES = _card_test_references()


def test_the_launch_entries_and_card_tests_are_found():
    assert len(ENTRIES) >= 30 and len({s for s, _ in ENTRIES}) == len(list(CSRC.glob("*.cu")))
    assert {"fused_mha_packed", "flash_attention", "int8_linear"} <= CARD_REFERENCES


@pytest.mark.parametrize("source,entry", ENTRIES, ids=[e for _, e in ENTRIES])
def test_every_launch_entry_is_reached_by_a_card_test(source, entry):
    wrappers = _wrappers(entry)
    assert wrappers, f"{source}: no public wrapper in team_tpu_torch/ops launches {entry}"
    assert wrappers & CARD_REFERENCES, (f"{source}: no cuda-marked test calls {entry}'s "
                                        f"wrappers {sorted(wrappers)}")
