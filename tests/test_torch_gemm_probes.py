"""Kernels #27, #28 and #30: the GEMM probes' plain versions against the
scripts' own Pallas kernels, and the three probe entry points on the CPU.

Each script is loaded by path (its persistent-cache hook made a no-op; its
file is not edited) and its kernel run through ``pl.pallas_call(...,
interpret=True)``:
- #27 ``scripts/int8_probe.py:_mm_kernel`` with its VMEM accumulator at
  M = N = K = 64 in 32 x 32 x 32 blocks, int8 -> int32 and bf16 -> f32;
- #28 ``scripts/int8_mxu_ceiling.py:_kernel_windows`` with the module's M, K
  and REPS set by monkeypatch (16, 32, and 5 or 70 repetitions: 70 uses
  windows 0-5 twice), int8 and bf16;
- #30 ``scripts/r5_megakernel_probe.py:mlp_mega_2d`` (block_m 8, a ragged
  last block) and ``mlp_mega_3d`` (block_b 1) at B=2, S=7, K=64, N=256, on
  the script's scales (s1 = s2 = 2e-4, qi = 30, most hq saturated) and on
  smaller ones (s1 = 2e-5, qi = 4, few saturated), and ``xla_pair``.
Tolerances: int8 bit for bit; #27 bf16 within ``probe_mm_bf16_limit`` ((K/16
+ 1) ulps of |x|@|w|; at this size every sum is an exact integer below 2^24,
and it is bit for bit); #28 bf16 within ``CEILING_BF16_SHARE`` of the largest
|ref|; #30 within ``mlp_mega_limit``: bit for bit on every row with no hq
near a rounding edge, else 127·s2 per near-edge value plus one bf16 step;
the float intermediate is checked finite before any int8 conversion.

Then the three probe modules run end to end with ``--device cpu`` at tiny
sizes, draw the scripts' inputs, and refuse the card where there is none."""

import functools
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from team_tpu_torch.ops import gemm_probe as gp
from team_tpu_torch.scripts import int8_mxu_ceiling, int8_probe, r5_megakernel_probe

REPO = Path(__file__).resolve().parents[1]


def _load(monkeypatch, name):
    import team_tpu.utils.jax_cache as jax_cache

    monkeypatch.setattr(jax_cache, "enable", lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location(f"{name}_script", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# #27 pallas_mm
# ---------------------------------------------------------------------------

MM, MB = 64, 32


def _pallas_mm(mod, x, w, acc):
    call = pl.pallas_call(
        mod._mm_kernel, grid=(MM // MB, MM // MB, MM // MB),
        in_specs=[pl.BlockSpec((MB, MB), lambda i, j, kk: (i, kk)),
                  pl.BlockSpec((MB, MB), lambda i, j, kk: (kk, j))],
        out_specs=pl.BlockSpec((MB, MB), lambda i, j, kk: (i, j)),
        out_shape=jax.ShapeDtypeStruct((MM, MM), acc),
        scratch_shapes=[pltpu.VMEM((MB, MB), acc)], interpret=True)
    return np.array(call(x, w))


def _mm_inputs():
    rng = np.random.default_rng(0)
    x = rng.integers(-127, 128, (MM, MM), dtype=np.int8)
    w = rng.integers(-127, 128, (MM, MM), dtype=np.int8)
    return x, w


def test_probe_mm_int8_matches_the_script_kernel(monkeypatch):
    mod = _load(monkeypatch, "int8_probe")
    x, w = _mm_inputs()
    want = _pallas_mm(mod, jnp.asarray(x), jnp.asarray(w), jnp.int32)
    np.testing.assert_array_equal(want, x.astype(np.int32) @ w.astype(np.int32))
    got = gp.probe_mm(_t(x), gp.column_major(_t(w)), torch.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_probe_mm_bf16_matches_the_script_kernel(monkeypatch):
    mod = _load(monkeypatch, "int8_probe")
    x, w = _mm_inputs()
    want = _pallas_mm(mod, jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16),
                      jnp.float32)
    xb, wb = _t(x).to(torch.bfloat16), _t(w).to(torch.bfloat16)
    got = gp.probe_mm(xb, wb)
    assert got.dtype == torch.float32
    err = (got - torch.from_numpy(want)).abs()
    assert bool((err <= gp.probe_mm_bf16_limit(xb, wb)).all())
    assert err.max().item() == 0.0  # integer sums below 2^24 are exact in f32


def test_probe_mm_rejects_mixed_types():
    x = torch.zeros((4, 32), dtype=torch.int8)
    with pytest.raises(TypeError):
        gp.probe_mm(x, torch.zeros((32, 8), dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        gp.probe_mm(x, torch.zeros((32, 8), dtype=torch.int8), torch.float32)
    with pytest.raises(ValueError):
        gp.probe_mm(x, torch.zeros((16, 8), dtype=torch.int8))


# ---------------------------------------------------------------------------
# #28 the matrix-unit ceiling
# ---------------------------------------------------------------------------

CM, CK = 16, 32


@pytest.mark.parametrize("reps", [5, 70])
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_mxu_ceiling_matches_the_script_kernel(monkeypatch, dtype, reps):
    mod = _load(monkeypatch, "int8_mxu_ceiling")
    for name, value in dict(M=CM, K=CK, N=CK, REPS=reps).items():
        monkeypatch.setattr(mod, name, value)
    tdt = torch.int8 if dtype == "int8" else torch.bfloat16
    x, w = int8_mxu_ceiling.make_inputs(tdt, CM, CK, torch.device("cpu"))
    jdt, acc = (jnp.int8, jnp.int32) if dtype == "int8" else (jnp.bfloat16, jnp.float32)
    call = pl.pallas_call(
        functools.partial(mod._kernel_windows, acc_dtype=acc), grid=(1,),
        in_specs=[pl.BlockSpec((CM + 512, CK), lambda i: (0, 0)),
                  pl.BlockSpec((CK, CK), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((CM, CK), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((CM, CK), jnp.float32), interpret=True)
    to_j = lambda t: jnp.asarray(t.float().numpy()).astype(jdt)  # noqa: E731
    want = torch.from_numpy(np.asarray(call(to_j(x), to_j(w))))
    got = gp.mxu_ceiling(x, w, reps=reps, m=CM)
    assert got.dtype == torch.float32 and tuple(got.shape) == (CM, CK)
    if dtype == "int8":
        assert torch.equal(got, want)
    else:
        err = (got - want).abs().max().item()
        assert err <= gp.CEILING_BF16_SHARE * want.abs().max().item(), err


def test_mxu_ceiling_counts_every_repetition():
    """A window's count is how many i < reps fall on it; the plain version
    equals the sum of the reps products taken one by one."""
    assert gp.window_counts(2000)[:16] == [32] * 16 and gp.window_counts(2000)[16:] == [31] * 48
    assert sum(gp.window_counts(2000)) == 2000 and sum(gp.window_counts(70)) == 70
    x, w = int8_mxu_ceiling.make_inputs(torch.int8, CM, CK, torch.device("cpu"))
    one_by_one = sum(x[8 * (i % 64):8 * (i % 64) + CM].long() @ w.long() for i in range(70))
    assert torch.equal(gp.mxu_ceiling(x, w, reps=70, m=CM), one_by_one.float())


def test_mxu_ceiling_rejects_short_x():
    x = torch.zeros((CM + 503, CK), dtype=torch.int8)
    with pytest.raises(ValueError):
        gp.mxu_ceiling(x, torch.zeros((CK, CK), dtype=torch.int8), reps=5, m=CM)


def test_ceiling_groups_fill_the_card():
    """One CTA (a tile and a range of the products) an SM, in one wave: the
    probe's 12 tiles take 11 ranges, 132 CTAs on 132 SMs."""
    assert gp.ceiling_tiles(512, 768) == 12 and gp.ceiling_groups(12, 132) == 11
    assert gp.ceiling_groups(1, 132) == 132 and gp.ceiling_groups(66, 132) == 2
    assert gp.ceiling_groups(132, 132) == 1 and gp.ceiling_groups(1000, 132) == 1


# (m, n, reps): the probe's shape; no product; fewer products than ranges; m
# not a multiple of 128; n not a multiple of 256
SPLIT_CASES = {"probe": (512, 768, 2000), "reps_0": (512, 768, 0), "reps_below_groups": (512, 768, 5),
               "ragged_m": (200, 768, 2000), "ragged_n": (512, 264, 70)}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_ceiling_split_covers_every_product_once_window_major(case):
    """The ranges of ``ceiling_split`` for the grid of the shape on 132 SMs:
    every product in exactly one range, ranges in order and window-major
    (the groups' (window, products) joined give ``window_counts``), sizes
    that differ by at most one; the tiles cover [m, n] and the grid is at
    most one wave."""
    m, n, reps = SPLIT_CASES[case]
    tiles = gp.ceiling_tiles(m, n)
    rows, cols = math.ceil(m / 128), math.ceil(n / 256)
    assert tiles == rows * cols and (rows - 1) * 128 < m <= rows * 128
    assert (cols - 1) * 256 < n <= cols * 256
    groups = gp.ceiling_groups(tiles, 132)
    assert tiles * groups <= 132 and tiles * (groups + 1) > 132
    split = gp.ceiling_split(reps, groups)
    assert len(split) == groups
    sizes = [sum(c for _, c in ranges) for ranges in split]
    assert sum(sizes) == reps and max(sizes) - min(sizes) <= 1
    joined = {}
    order = [j for ranges in split for j, c in ranges if c > 0]
    assert order == sorted(order)
    for ranges in split:
        for j, c in ranges:
            assert c > 0
            joined[j] = joined.get(j, 0) + c
    assert joined == {j: c for j, c in enumerate(gp.window_counts(reps)) if c}
    if case == "probe":
        assert groups == 11 and tiles * groups == 132 and set(sizes) == {181, 182}
    if case == "reps_below_groups":
        assert sizes.count(0) == groups - reps and split[0] == []


def _ceiling_order_model(x, w, reps, m, groups, rounding):
    """The bf16 ceiling in the kernel's order, in f32: each group's one
    accumulator over its range, window by window, 64 elements of K a stage,
    the stage's four k16 steps once for each of the window's products there
    (each step's 16 products summed exactly, then added with one rounding:
    to nearest, or toward zero as a tensor core may), then the partials
    added in group order, rounded to nearest."""
    k = x.shape[1]
    xd, wd = x.double(), w.double()
    total = None
    for ranges in gp.ceiling_split(reps, groups):
        acc = torch.zeros((m, w.shape[1]), dtype=torch.float32)
        for j, count in ranges:
            xj = xd[8 * j:8 * j + m]
            steps = [xj[:, s:s + 16] @ wd[s:s + 16] for s in range(0, k, 16)]
            for kc in range(0, len(steps), 4):
                for _ in range(count):
                    for p in steps[kc:kc + 4]:
                        exact = acc.double() + p
                        acc = exact.float()
                        if rounding == "toward_zero":
                            acc = torch.where(acc.double().abs() > exact.abs(),
                                              torch.nextafter(acc, torch.zeros_like(acc)), acc)
        total = acc if total is None else total + acc
    return total


@pytest.mark.parametrize("rounding", ["nearest", "toward_zero"])
def test_ceiling_bf16_order_stays_within_its_share(rounding):
    """An f32 model of the kernel's bf16 summation order (2000 products in
    the probe's 11 ranges, at M 16, K = N 128) stays within
    ``CEILING_BF16_SHARE`` of the plain version; the same model with one
    product left out does not."""
    m, k, reps, groups = 16, 128, 2000, 11
    x, w = int8_mxu_ceiling.make_inputs(torch.bfloat16, m, k, torch.device("cpu"))
    ref = gp.mxu_ceiling_reference(x, w, reps, m)
    tol = gp.CEILING_BF16_SHARE * ref.abs().max().item()
    got = _ceiling_order_model(x, w, reps, m, groups, rounding)
    assert (got - ref).abs().max().item() <= tol, ((got - ref).abs().max().item(), tol)
    short = _ceiling_order_model(x, w, reps - 1, m, groups, rounding)
    assert (short - ref).abs().max().item() > tol


# ---------------------------------------------------------------------------
# #30 the int8 MLP megakernel
# ---------------------------------------------------------------------------

MB_, MS, MK, MN = 2, 7, 64, 256
SCALES = {"script": (2e-4, 2e-4, 30.0), "unsaturated": (2e-5, 2e-4, 4.0)}


def _mega_inputs(scales):
    s1v, s2v, qiv = SCALES[scales]
    rng = np.random.default_rng(0)
    w1 = rng.integers(-127, 128, (MK, MN), dtype=np.int8)
    w2 = rng.integers(-127, 128, (MN, MK), dtype=np.int8)
    x = rng.integers(-127, 128, (MB_, MS, MK), dtype=np.int8)
    s1 = np.full((1, MN), s1v, np.float32)
    s2 = np.full((1, MK), s2v, np.float32)
    qi = np.full((1, MN), qiv, np.float32)
    return x, w1, s1, w2, s2, qi


def _check_mega(got, want, args):
    x, w1, s1, w2, s2, qi = args
    hidden = gp.mlp_mega_hidden(x, w1, s1, qi)
    assert all(bool(torch.isfinite(t).all()) for t in hidden.values())
    edges = gp.mlp_mega_edge_rows(x, w1, s1, qi)
    limit = gp.mlp_mega_limit(want, edges, s2)
    err = (got.float() - want.float()).abs()
    assert got.shape == want.shape and bool((err <= limit).all()), (err.max(), edges)
    return edges


@pytest.mark.parametrize("scales", list(SCALES))
def test_mlp_mega_matches_the_script_kernels(monkeypatch, scales):
    mod = _load(monkeypatch, "r5_megakernel_probe")
    arrays = _mega_inputs(scales)
    jargs = [jnp.asarray(a) for a in arrays]
    args = [_t(a) for a in arrays]
    x = args[0]
    want = gp.mlp_mega_reference(*args)
    saturated = (gp.mlp_mega_hidden(x, args[1], args[2], args[5])["v"].abs() >= 127).float().mean()
    assert (saturated > 0.3) if scales == "script" else (saturated < 0.05)
    got2 = gp.mlp_mega_2d(x.reshape(-1, MK), *args[1:], block_m=8, interpret=True)
    got3 = gp.mlp_mega_3d(x, *args[1:], block_b=1, interpret=True)
    assert torch.equal(got2.reshape(x.shape), got3) and got3.dtype == torch.bfloat16
    pallas2 = mod.mlp_mega_2d(jargs[0].reshape(-1, MK), *jargs[1:], block_m=8, interpret=True)
    pallas3 = mod.mlp_mega_3d(*jargs, block_b=1, interpret=True)
    xla = mod.xla_pair(*jargs)
    for out in (pallas2, pallas3, xla):
        theirs = torch.from_numpy(np.asarray(out.astype(jnp.float32))).reshape(x.shape)
        _check_mega(theirs, want, args)
    # the port's torch composition (the probe's xla variant) too
    _check_mega(r5_megakernel_probe.xla_pair(*args), want, args)


def test_mlp_mega_limit_is_exact_without_edges():
    ref = torch.tensor([[1.0, -2.0], [3.0, 4.0]]).to(torch.bfloat16)
    limit = gp.mlp_mega_limit(ref, torch.tensor([0, 2]), torch.full((1, 2), 2e-4))
    assert torch.equal(limit[0], torch.zeros(2))
    assert bool((limit[1] >= 2 * 127 * 2e-4).all())


def test_mlp_mega_rejects_bad_shapes():
    x, w1, s1, w2, s2, qi = (_t(a) for a in _mega_inputs("script"))
    with pytest.raises(ValueError):
        gp.mlp_mega_2d(x, w1, s1, w2, s2, qi)  # 3-D x on the 2-D entry
    with pytest.raises(ValueError):
        gp.mlp_mega_3d(x, w1, s1, w2.t(), s2, qi)
    with pytest.raises(TypeError):
        gp.mlp_mega_3d(x.float(), w1, s1, w2, s2, qi)


# ---------------------------------------------------------------------------
# the probe entry points
# ---------------------------------------------------------------------------

def test_int8_probe_runs_on_the_cpu(capsys):
    res = int8_probe.main(["--device", "cpu", "--size", "64", "--rounds", "1"])
    assert list(res) == ["probe_mm int8->int32", "torch._int_mm int8->int32",
                         "probe_mm bf16->f32", "torch.matmul bf16->bf16"]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("# device: cpu") and "32 inputs" in lines[0]
    assert lines[1].endswith("(every output): OK")
    assert all("ms/call" in ln and ln.endswith("TOPS") for ln in lines[2:])


def test_mxu_ceiling_probe_runs_on_the_cpu(capsys):
    res = int8_mxu_ceiling.main(["--device", "cpu", "--m", "16", "--k", "32", "--reps", "5",
                                 "--rounds", "1"])
    assert list(res) == ["int8", "bf16"] and all(r["ms"] > 0 for r in res.values())
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("# device: cpu")
    assert [ln.split()[0] for ln in lines[1:]] == ["int8", "bf16"]
    assert all("ms for 5 dots" in ln and "wgmma ceiling" in ln for ln in lines[1:])


def test_megakernel_probe_runs_on_the_cpu(capsys):
    res = r5_megakernel_probe.main(["--device", "cpu", "--batch", "1", "--layers", "1",
                                    "--inputs", "1", "--rounds", "1",
                                    "--variants", "xla,mk2d256,mk3d8"])
    assert list(res) == ["xla", "mk2d256", "mk3d8"] and res["xla"]["maxerr"] == 0.0
    assert res["mk2d256"]["maxerr"] == res["mk3d8"]["maxerr"]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("# device: cpu") and "every mk* variant runs the one kernel" in lines[0]
    assert all("ms/pair" in ln and "maxerr=" in ln for ln in lines[1:])


def test_probe_inputs_are_the_scripts():
    """Each probe draws its script's inputs from the same generator, in the
    same order (at small sizes)."""
    rng = np.random.default_rng(0)
    xs = [rng.integers(-127, 128, (64, 64), dtype=np.int8) for _ in range(32)]
    w = rng.integers(-127, 128, (64, 64), dtype=np.int8)
    got_xs, got_w = int8_probe.make_inputs(64, torch.device("cpu"))
    assert len(got_xs) == 32 and all(np.array_equal(g.numpy(), x) for g, x in zip(got_xs, xs))
    np.testing.assert_array_equal(got_w.numpy(), w)
    assert got_w.stride() == (1, 64)

    rng = np.random.default_rng(0)
    x = rng.integers(-127, 128, (16 + 512, 32), dtype=np.int8)
    w = rng.integers(-3, 4, (32, 32), dtype=np.int8)
    gx, gw = int8_mxu_ceiling.make_inputs(torch.int8, 16, 32, torch.device("cpu"))
    np.testing.assert_array_equal(gx.numpy(), x)
    np.testing.assert_array_equal(gw.numpy(), w)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((16 + 512, 32)) * 0.1).astype(np.float32)
    gx, _ = int8_mxu_ceiling.make_inputs(torch.bfloat16, 16, 32, torch.device("cpu"))
    assert torch.equal(gx, torch.from_numpy(x).to(torch.bfloat16))

    rng = np.random.default_rng(0)
    w1 = rng.integers(-127, 128, (768, 3072), dtype=np.int8)
    w2 = rng.integers(-127, 128, (3072, 768), dtype=np.int8)
    x0 = rng.integers(-127, 128, (1, 197, 768), dtype=np.int8)
    (gw1, s1, gw2, s2, qi), inputs = r5_megakernel_probe.make_inputs(1, 1, torch.device("cpu"))
    np.testing.assert_array_equal(gw1.numpy(), w1)
    np.testing.assert_array_equal(gw2.numpy(), w2)
    np.testing.assert_array_equal(inputs[0].numpy(), x0)
    assert float(s1[0, 0]) == np.float32(2e-4) and float(qi[0, 0]) == 30.0


@pytest.mark.parametrize("probe,args", [
    (int8_probe, ["--size", "64"]),
    (int8_mxu_ceiling, ["--m", "16", "--k", "32", "--reps", "5"]),
    (r5_megakernel_probe, ["--batch", "1", "--layers", "1", "--inputs", "1"])],
    ids=["int8_probe", "int8_mxu_ceiling", "r5_megakernel_probe"])
def test_probes_refuse_a_missing_card(monkeypatch, probe, args):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        probe.main(args)
