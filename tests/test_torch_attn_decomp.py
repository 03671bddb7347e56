"""Kernel #29: the q3i decomposition probe's variants and the two probe
entry points on the CPU.

Each variant's plain version (``mha_q3i_variant_reference``) is held against
``scripts/r4_attn_decomp.py:_variant_kernel`` run through
``pl.pallas_call(..., interpret=True)`` at B=2, S=72, H=2, Dh=64, on the
script's inputs (``np.random.default_rng(0)``), with its o_inv (20-60, where
``full`` saturates most outputs at +-127) and with o_inv 0.5-2 (few
clipped). Tolerance: at most one int8 step on under 1 % of the outputs (the
f32 row sum and exp2 may round differently across libraries; measured: bit
for bit), ``copy`` bit for bit. The float outputs are checked finite before
the int8 conversion, so no comparison rests on converting inf or NaN. The
script is loaded by path and its module constants are set with monkeypatch;
its file is not edited, and its persistent-cache hook is made a no-op.

Then both probe modules run end to end with ``--device cpu`` at a tiny
``--batch``/``--layers``, and refuse the card where there is none."""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from team_tpu_torch.ops import mha_short as tms
from team_tpu_torch.scripts import attn_shootout, r4_attn_decomp

REPO = Path(__file__).resolve().parents[1]
B, S, H, DH = 2, 72, 2, 64
MAX_SHARE = 0.01


@pytest.fixture
def script(monkeypatch):
    import team_tpu.utils.jax_cache as jax_cache

    monkeypatch.setattr(jax_cache, "enable", lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location("r4_attn_decomp_script",
                                                  REPO / "scripts" / "r4_attn_decomp.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    d = H * DH
    for name, value in dict(B=B, S=S, H=H, DH=DH, D=d, D3=3 * d).items():
        monkeypatch.setattr(mod, name, value)
    return mod


def _inputs(oinv_range):
    rng = np.random.default_rng(0)
    d = H * DH
    qkv = rng.integers(-80, 81, (B, S, 3 * d), dtype=np.int8)
    qks = rng.uniform(1e-4, 2e-4, (1, H)).astype(np.float32)
    qkm2 = rng.uniform(4, 7, (1, H)).astype(np.float32)
    oinv = rng.uniform(*oinv_range, (1, d)).astype(np.float32)
    return qkv, qks, qkm2, oinv


def _pallas_variant(mod, variant, qkv, qks, qkm2, oinv):
    d = H * DH
    kern = functools.partial(mod._variant_kernel, variant=variant)
    call = pl.pallas_call(
        kern, grid=(1,),
        in_specs=[pl.BlockSpec((B, S, 3 * d), lambda i: (0, 0, 0)),
                  pl.BlockSpec((1, H), lambda i: (0, 0)),
                  pl.BlockSpec((1, H), lambda i: (0, 0)),
                  pl.BlockSpec((1, d), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((B, S, d), lambda i: (0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((B, S, d), jnp.int8), interpret=True)
    return np.asarray(call(*(jnp.asarray(a) for a in (qkv, qks, qkm2, oinv))))


@pytest.mark.parametrize("oinv_range", [(20, 60), (0.5, 2)], ids=["script_oinv", "unclipped"])
@pytest.mark.parametrize("variant", list(tms.Q3I_VARIANTS))
def test_variant_plain_version_matches_the_script_kernel(script, variant, oinv_range):
    qkv, qks, qkm2, oinv = _inputs(oinv_range)
    want = _pallas_variant(script, variant, qkv, qks, qkm2, oinv)
    args = [torch.from_numpy(a) for a in (qkv, qks, qkm2, oinv)]
    got = tms.fused_mha_q3i_variant(*args, H, variant)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    if variant == "copy":
        np.testing.assert_array_equal(got.numpy(), want)
        return
    assert torch.isfinite(tms.mha_q3i_variant_float(*args, H, variant)).all()
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < MAX_SHARE, (diff.max(), (diff > 0).mean())


def test_full_is_the_packed_q3i_kernel_with_unit_v_scales():
    """``full`` is the packed q3i route (static softmax, ones-column row sum)
    with v's dequant scale 1, bit for bit."""
    qkv, qks, qkm2, oinv = (torch.from_numpy(a) for a in _inputs((0.5, 2)))
    d = H * DH
    want = tms.fused_mha_packed_q3i(qkv, torch.ones(1, 3 * d), qks, oinv, H, qk_m2=qkm2)
    assert torch.equal(tms.fused_mha_q3i_variant(qkv, qks, qkm2, oinv, H, "full"), want)


def test_variant_wrapper_rejects_what_it_does_not_take():
    qkv, qks, qkm2, oinv = (torch.from_numpy(a) for a in _inputs((0.5, 2)))
    with pytest.raises(ValueError):
        tms.fused_mha_q3i_variant(qkv, qks, qkm2, oinv, H, "nosuch")
    with pytest.raises(ValueError):  # the first Dh keys of a row must exist
        tms.fused_mha_q3i_variant(qkv[:, :40].contiguous(), qks, qkm2, oinv, H, "qkonly")
    with pytest.raises(ValueError):
        tms.fused_mha_q3i_variant(qkv, qks, None, oinv, H, "full")
    with pytest.raises(TypeError):
        tms.fused_mha_q3i_variant(qkv.float(), qks, qkm2, oinv, H, "full")


def test_r4_probe_runs_on_the_cpu(capsys):
    ms = r4_attn_decomp.main(["--device", "cpu", "--batch", "1", "--layers", "2", "--rounds", "1"])
    assert list(ms) == list(r4_attn_decomp.VARIANTS) and all(t > 0 for t in ms.values())
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("# device: cpu")
    assert [ln.split()[0] for ln in lines[1:]] == list(r4_attn_decomp.VARIANTS)
    assert all("ms/layer" in ln and "/ 2 layers)" in ln for ln in lines[1:])


def test_r4_probe_inputs_are_the_scripts():
    """The probe draws ``scripts/r4_attn_decomp.py:main``'s inputs from the
    same generator, in the same order (here at batch 2)."""
    rng = np.random.default_rng(0)
    want = (rng.integers(-80, 81, (2, 197, 2304), dtype=np.int8),
            rng.uniform(1e-4, 2e-4, (1, 12)).astype(np.float32),
            rng.uniform(4, 7, (1, 12)).astype(np.float32),
            rng.uniform(20, 60, (1, 768)).astype(np.float32))
    got = r4_attn_decomp.make_inputs(2, torch.device("cpu"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("mode", ["all", "qpad128"])
def test_attn_shootout_runs_on_the_cpu(capsys, mode):
    ms = attn_shootout.main(["--device", "cpu", "--batch", "1", "--layers", "1", "--rounds", "1",
                             "--mode", mode])
    assert list(ms) == list(attn_shootout.implementations(mode)) and len(ms) == (
        4 if mode == "all" else 2)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# device: cpu")
    assert all(ln.endswith("ms/layer") for ln in out[1:])


@pytest.mark.parametrize("probe", [attn_shootout, r4_attn_decomp])
def test_probes_refuse_a_missing_card(monkeypatch, probe):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        probe.main(["--batch", "1", "--layers", "1"])
