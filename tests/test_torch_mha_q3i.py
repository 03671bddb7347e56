"""Integer-QKᵀ attention of the int8 tier: the port's plain versions against
the JAX Pallas kernels (interpret mode, as tests/test_int8.py runs them on
the CPU), and the wrappers' checks. The CUDA kernels are held against the
plain versions on the card in tests/test_torch_cuda.py.

Tolerance, as tests/test_int8.py:450,479 hold the TPU kernel's own variants:
at most one int8 step anywhere and under 1 % of the outputs differing. The
q·k sums are exact integers on both sides; what may differ is the last bit
of the exponent's argument (XLA may fuse acc·s − m2 into one FMA) and the
order of the f32 sums, and either can move a value across a rounding edge."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import team_tpu.ops.mha_short as jmha
from team_tpu_torch.ops.mha_short import (fused_mha_packed_q3i, fused_mha_packed_q3i_cls,
                                          mha_packed_q3i_reference)

# (batch, seq, heads, head width, causal, kv_len, static softmax)
CASES = [
    pytest.param(2, 24, 4, 16, False, None, True, id="static"),
    pytest.param(2, 24, 4, 16, False, None, False, id="rowmax"),
    pytest.param(2, 21, 2, 16, True, None, False, id="causal"),
    pytest.param(2, 24, 4, 16, False, 17, False, id="kvlen"),
    pytest.param(2, 21, 2, 16, True, 15, False, id="causal-kvlen"),
    pytest.param(1, 197, 12, 64, False, None, True, id="vision-full-width-static"),
    pytest.param(1, 197, 12, 64, False, None, False, id="vision-full-width-rowmax"),
    pytest.param(1, 77, 8, 64, True, None, False, id="text-full-width-causal"),
]


def _inputs(b, s, heads, dh, seed=0):
    """int8 qkv and scales in the ranges of tests/test_int8.py, with the
    logit scale shrunk with √dh so that the logits stay in a realistic range."""
    rng = np.random.default_rng(seed)
    d = heads * dh
    qkv = rng.integers(-127, 128, (b, s, 3 * d)).astype(np.int8)
    deq = rng.uniform(0.01, 0.03, (1, 3 * d)).astype(np.float32)
    qks = (rng.uniform(1e-4, 3e-4, (1, heads)) * 4 / np.sqrt(dh)).astype(np.float32)
    oinv = rng.uniform(20, 60, (1, d)).astype(np.float32)
    m2 = rng.uniform(3, 6, (1, heads)).astype(np.float32)
    return qkv, deq, qks, oinv, m2


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def assert_within_one_step(got, want):
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 0.01, (diff > 0).mean()


@pytest.mark.parametrize("b,s,h,dh,causal,kv_len,static", CASES)
def test_reference_matches_jax_kernel(b, s, h, dh, causal, kv_len, static):
    qkv, deq, qks, oinv, m2 = _inputs(b, s, h, dh)
    m2 = m2 if static else None
    want = jmha.fused_mha_packed_q3i(jnp.asarray(qkv), jnp.asarray(deq), jnp.asarray(qks),
                                     jnp.asarray(oinv), h, causal=causal, kv_len=kv_len,
                                     interpret=True,
                                     qk_m2=None if m2 is None else jnp.asarray(m2))
    got = mha_packed_q3i_reference(*_t(qkv, deq, qks, oinv), h, causal, kv_len,
                                   None if m2 is None else torch.from_numpy(m2))
    assert got.dtype == torch.int8 and got.shape == (b, s, h * dh)
    assert_within_one_step(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("b,s,h,dh", [(4, 24, 4, 16), (2, 197, 12, 64)])
@pytest.mark.parametrize("static", [True, False])
def test_cls_reference_matches_jax_kernel(b, s, h, dh, static):
    qkv, deq, qks, oinv, m2 = _inputs(b, s, h, dh, seed=1)
    m2 = m2 if static else None
    want = jmha.fused_mha_packed_q3i_cls(jnp.asarray(qkv), jnp.asarray(deq), jnp.asarray(qks),
                                         jnp.asarray(oinv), h, interpret=True,
                                         qk_m2=None if m2 is None else jnp.asarray(m2))
    args = _t(qkv, deq, qks, oinv)
    m2_t = None if m2 is None else torch.from_numpy(m2)
    got = mha_packed_q3i_reference(*args, h, qk_m2=m2_t, rows=1)
    assert got.shape == (b, 1, h * dh)
    assert_within_one_step(got.numpy(), np.asarray(want))
    # the CLS row is row 0 of the full computation, bit for bit in the plain version
    full = mha_packed_q3i_reference(*args, h, qk_m2=m2_t)
    torch.testing.assert_close(got, full[:, :1], rtol=0, atol=0)


def test_wrappers_on_cpu_are_the_plain_versions_and_count_nothing():
    qkv, deq, qks, oinv, m2 = _t(*_inputs(2, 21, 2, 16, seed=2))
    before = (fused_mha_packed_q3i.launches, fused_mha_packed_q3i_cls.launches)
    torch.testing.assert_close(fused_mha_packed_q3i(qkv, deq, qks, oinv, 2, qk_m2=m2),
                               mha_packed_q3i_reference(qkv, deq, qks, oinv, 2, qk_m2=m2),
                               rtol=0, atol=0)
    # a mask takes the row-max form even when qk_m2 is given, as on the TPU
    torch.testing.assert_close(
        fused_mha_packed_q3i(qkv, deq, qks, oinv, 2, causal=True, kv_len=17, qk_m2=m2),
        mha_packed_q3i_reference(qkv, deq, qks, oinv, 2, True, 17), rtol=0, atol=0)
    torch.testing.assert_close(fused_mha_packed_q3i_cls(qkv, deq, qks, oinv, 2, qk_m2=m2),
                               mha_packed_q3i_reference(qkv, deq, qks, oinv, 2, qk_m2=m2, rows=1),
                               rtol=0, atol=0)
    assert (fused_mha_packed_q3i.launches, fused_mha_packed_q3i_cls.launches) == before


def test_softmax_knob_f32_takes_the_row_max_form(monkeypatch):
    qkv, deq, qks, oinv, m2 = _t(*_inputs(2, 24, 4, 16, seed=3))
    monkeypatch.setenv("TEAM_QI_SOFTMAX", "f32")
    torch.testing.assert_close(fused_mha_packed_q3i(qkv, deq, qks, oinv, 4, qk_m2=m2),
                               mha_packed_q3i_reference(qkv, deq, qks, oinv, 4), rtol=0, atol=0)
    torch.testing.assert_close(fused_mha_packed_q3i_cls(qkv, deq, qks, oinv, 4, qk_m2=m2),
                               mha_packed_q3i_reference(qkv, deq, qks, oinv, 4, rows=1),
                               rtol=0, atol=0)


def _good():
    return _t(*_inputs(1, 8, 2, 16, seed=4))


@pytest.mark.parametrize("mutate,kw,exc", [
    pytest.param(lambda a: [a[0].float()] + a[1:], {}, TypeError, id="not-int8"),
    pytest.param(lambda a: [a[0][..., :-1]] + a[1:], {}, ValueError, id="not-packed"),
    pytest.param(lambda a: [a[0]] + [a[1][:, :-1]] + a[2:], {}, ValueError, id="deq-size"),
    pytest.param(lambda a: a[:2] + [a[2][:, :1]] + a[3:], {}, ValueError, id="qk_scale-size"),
    pytest.param(lambda a: a, {"kv_len": 0}, ValueError, id="kv_len-zero"),
    pytest.param(lambda a: a, {"kv_len": 9}, ValueError, id="kv_len-past-seq"),
    # modes the wrapper has (exc None): taken, and held against team_tpu's kernel
    pytest.param(lambda a: a, {"pv_int8": True}, None, id="pv_int8"),
    pytest.param(lambda a: a, {"defer_norm": True}, None, id="defer_norm"),
    pytest.param(lambda a: [a[0].to("meta")] + a[1:], {}, ValueError, id="meta-device"),
])
def test_wrapper_rejects_bad_input(mutate, kw, exc):
    qkv, deq, qks, oinv, m2 = mutate(_good())
    if exc is None:
        want = jmha.fused_mha_packed_q3i(*(jnp.asarray(t.numpy()) for t in (qkv, deq, qks, oinv)),
                                         2, interpret=True, qk_m2=jnp.asarray(m2.numpy()), **kw)
        assert_within_one_step(fused_mha_packed_q3i(qkv, deq, qks, oinv, 2, qk_m2=m2, **kw).numpy(),
                               np.asarray(want))
        return
    with pytest.raises(exc):
        fused_mha_packed_q3i(qkv, deq, qks, oinv, 2, qk_m2=m2, **kw)


def test_wrappers_reject_heads_and_unported_knobs(monkeypatch):
    """Bad heads raise. The knobs ``TEAM_QI_SOFTMAX=exp2i`` and
    ``TEAM_QI_ROWSUM=reduce`` are ported: both wrappers follow team_tpu's
    kernels under each (its module globals set and JAX's caches cleared,
    since its jitted wrappers read them when traced)."""
    import jax

    qkv, deq, qks, oinv, m2 = _good()
    with pytest.raises(ValueError):
        fused_mha_packed_q3i_cls(qkv, deq, qks, oinv, 3, qk_m2=m2)
    args = [jnp.asarray(t.numpy()) for t in (qkv, deq, qks, oinv)]
    for knob, value in (("TEAM_QI_SOFTMAX", "exp2i"), ("TEAM_QI_ROWSUM", "reduce")):
        with monkeypatch.context() as m:
            m.setenv(knob, value)
            m.setattr(jmha, "_QI_" + knob.split("_")[-1], value)
            jax.clear_caches()
            for port, ref in ((fused_mha_packed_q3i, jmha.fused_mha_packed_q3i),
                              (fused_mha_packed_q3i_cls, jmha.fused_mha_packed_q3i_cls)):
                want = ref(*args, 2, interpret=True, qk_m2=jnp.asarray(m2.numpy()))
                assert_within_one_step(port(qkv, deq, qks, oinv, 2, qk_m2=m2).numpy(),
                                       np.asarray(want))
        jax.clear_caches()


def test_the_too_long_code_is_the_kernel_sources():
    """The entries of ``csrc/mha_packed_q3i.cu`` return ``kErrTooLong``,
    launching nothing, when S outgrows their kernel's shared memory; the
    wrapper raises ``ValueError`` on the same value (the card tests run the
    longest S and one more)."""
    import re
    from pathlib import Path

    import team_tpu_torch.ops.mha_short as tms

    text = (Path(tms.__file__).resolve().parents[1] / "csrc" / tms._Q3I_SOURCE).read_text()
    code = re.search(r"constexpr int kErrTooLong = (-?\d+);", text)
    assert code and int(code.group(1)) == tms._Q3I_TOO_LONG
    assert text.count("if (smem > kSmemOptin) return kErrTooLong;") == 2  # both launchers
