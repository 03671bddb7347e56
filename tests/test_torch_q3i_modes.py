"""The integer-QKᵀ attention's other modes and kernels: the port's plain
versions against the JAX Pallas kernels (interpret mode, as
tests/test_int8.py runs them on the CPU).

- ``fused_mha_packed_q3i`` under ``TEAM_QI_SOFTMAX`` (static, f32, exp2i),
  ``TEAM_QI_ROWSUM`` (mxu, reduce), ``pv_int8`` and ``defer_norm``, alone
  and combined, masked and not;
- ``fused_mha_packed_q3i_cls_split`` (the split CLS query) and
  ``fused_mha_packed_q3i_sb`` (sequence-major);
- the CLS kernels' knob handling: static only under
  ``TEAM_QI_SOFTMAX=static``, the f32 row-max form for every other value,
  ``TEAM_QI_ROWSUM`` ignored.

team_tpu reads ``TEAM_QI_SOFTMAX`` and ``TEAM_QI_ROWSUM`` into module globals
when it is imported, and ``jax.jit`` keeps the first trace of a shape, so
the ``knobs`` fixture sets the globals and clears JAX's caches around each
case; the port reads the environment at each call, so the fixture sets that
too. The CUDA kernels are held against these plain versions on the card in
tests/test_torch_cuda.py.

Tolerance, as tests/test_torch_mha_q3i.py: at most one int8 step anywhere
and under 1 % of the outputs differing (the q·k sums are exact integers on
both sides; the last bit of an exponent's argument, the order of the f32
sums and, under ``pv_int8``, a p·127 at a rounding edge may differ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import team_tpu.ops.mha_short as jmha
from team_tpu_torch.ops import mha_short as tms


def _inputs(b, s, heads, dh, seed=0):
    """int8 qkv and scales in the ranges of tests/test_torch_mha_q3i.py."""
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


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def assert_within_one_step(got, want):
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 0.01, (diff > 0).mean()


@pytest.fixture
def knobs(monkeypatch):
    """``set(softmax, rowsum)``: the knobs on both sides, JAX's caches cleared
    before the case runs and after the globals are restored."""
    jax.clear_caches()

    def set_knobs(softmax="static", rowsum="mxu"):
        monkeypatch.setattr(jmha, "_QI_SOFTMAX", softmax)
        monkeypatch.setattr(jmha, "_QI_ROWSUM", rowsum)
        monkeypatch.setenv("TEAM_QI_SOFTMAX", softmax)
        monkeypatch.setenv("TEAM_QI_ROWSUM", rowsum)
        jax.clear_caches()

    yield set_knobs
    monkeypatch.undo()
    jax.clear_caches()


# (softmax, rowsum, pv_int8, defer_norm, causal, kv_len)
MODES = [
    pytest.param("exp2i", "mxu", False, False, False, None, id="exp2i"),
    pytest.param("exp2i", "mxu", False, False, True, None, id="exp2i-causal-is-f32"),
    pytest.param("f32", "reduce", False, False, False, None, id="f32-reduce"),
    pytest.param("static", "reduce", False, False, False, None, id="static-reduce"),
    pytest.param("static", "reduce", False, True, False, None, id="static-reduce-defer"),
    pytest.param("f32", "reduce", False, True, False, 17, id="f32-reduce-defer-kvlen"),
    pytest.param("exp2i", "reduce", False, True, False, None, id="exp2i-reduce-defer"),
    pytest.param("static", "mxu", False, True, False, None, id="mxu-defer-is-mxu"),
    pytest.param("static", "mxu", True, False, False, None, id="pv_int8-static"),
    pytest.param("f32", "mxu", True, False, False, None, id="pv_int8-f32"),
    pytest.param("static", "mxu", True, True, False, None, id="pv_int8-defer"),
    pytest.param("exp2i", "reduce", True, True, True, None, id="pv_int8-defer-causal"),
]


@pytest.mark.parametrize("softmax,rowsum,pv_int8,defer,causal,kv_len", MODES)
def test_modes_match_jax_kernel(knobs, softmax, rowsum, pv_int8, defer, causal, kv_len):
    knobs(softmax, rowsum)
    qkv, deq, qks, oinv, m2 = _inputs(2, 24, 4, 16, seed=10)
    want = jmha.fused_mha_packed_q3i(*_j(qkv, deq, qks, oinv), 4, causal=causal, kv_len=kv_len,
                                     interpret=True, pv_int8=pv_int8, defer_norm=defer,
                                     qk_m2=jnp.asarray(m2))
    got = tms.fused_mha_packed_q3i(*_t(qkv, deq, qks, oinv), 4, causal=causal, kv_len=kv_len,
                                   qk_m2=torch.from_numpy(m2), pv_int8=pv_int8, defer_norm=defer)
    assert got.dtype == torch.int8 and got.shape == (2, 24, 64)
    assert_within_one_step(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("softmax,pv_int8", [("exp2i", False), ("f32", True)])
def test_modes_at_the_vision_width(knobs, softmax, pv_int8):
    """The reduce row sum with the deferred divide at ViT-B/16's S, H and dh."""
    knobs(softmax, "reduce")
    qkv, deq, qks, oinv, m2 = _inputs(1, 197, 12, 64, seed=11)
    want = jmha.fused_mha_packed_q3i(*_j(qkv, deq, qks, oinv), 12, interpret=True,
                                     pv_int8=pv_int8, defer_norm=True, qk_m2=jnp.asarray(m2))
    got = tms.fused_mha_packed_q3i(*_t(qkv, deq, qks, oinv), 12, qk_m2=torch.from_numpy(m2),
                                   pv_int8=pv_int8, defer_norm=True)
    assert_within_one_step(got.numpy(), np.asarray(want))


def test_the_modes_change_results(knobs):
    """Each mode is a different arithmetic: against the default route, each
    moves some outputs (so a test that ignored the mode would see it)."""
    qkv, deq, qks, oinv, m2 = _t(*_inputs(2, 24, 4, 16, seed=12))
    knobs("static", "mxu")
    default = tms.fused_mha_packed_q3i(qkv, deq, qks, oinv, 4, qk_m2=m2)
    assert torch.equal(default, tms.fused_mha_packed_q3i(qkv, deq, qks, oinv, 4, qk_m2=m2,
                                                          defer_norm=True))
    variants = [tms.fused_mha_packed_q3i(qkv, deq, qks, oinv, 4, qk_m2=m2, pv_int8=True)]
    knobs("exp2i", "mxu")
    variants.append(tms.fused_mha_packed_q3i(qkv, deq, qks, oinv, 4, qk_m2=m2))
    knobs("static", "reduce")
    variants.append(tms.fused_mha_packed_q3i(qkv, deq, qks, oinv, 4, qk_m2=m2, defer_norm=True))
    for other in variants:
        assert (other != default).any()


@pytest.mark.parametrize("b,s,h,dh", [(4, 24, 4, 16), (2, 197, 12, 64)])
@pytest.mark.parametrize("static", [True, False])
def test_cls_split_matches_jax_kernel_and_the_packed_cls(b, s, h, dh, static):
    qkv, deq, qks, oinv, m2 = _inputs(b, s, h, dh, seed=13)
    d = h * dh
    m2 = m2 if static else None
    q, kv = qkv[:, :1, :d].copy(), qkv[:, :, d:].copy()
    want = jmha.fused_mha_packed_q3i_cls_split(*_j(q, kv, deq, qks, oinv), h, interpret=True,
                                               qk_m2=None if m2 is None else jnp.asarray(m2))
    m2_t = None if m2 is None else torch.from_numpy(m2)
    got = tms.fused_mha_packed_q3i_cls_split(*_t(q, kv, deq, qks, oinv), h, qk_m2=m2_t)
    assert got.dtype == torch.int8 and got.shape == (b, 1, d)
    assert_within_one_step(got.numpy(), np.asarray(want))
    packed = tms.fused_mha_packed_q3i_cls(*_t(qkv, deq, qks, oinv), h, qk_m2=m2_t)
    torch.testing.assert_close(got, packed, rtol=0, atol=0)


@pytest.mark.parametrize("s,b,h,dh", [(24, 2, 4, 16), (197, 2, 12, 64)])
def test_sb_matches_jax_kernel(s, b, h, dh):
    qkv, deq, qks, oinv, _ = _inputs(s, b, h, dh, seed=14)  # [S, B, 3D]
    want = jmha.fused_mha_packed_q3i_sb(*_j(qkv, deq, qks, oinv), h, interpret=True)
    got = tms.fused_mha_packed_q3i_sb(*_t(qkv, deq, qks, oinv), h)
    assert got.dtype == torch.int8 and got.shape == (s, b, h * dh) and got.is_contiguous()
    assert_within_one_step(got.numpy(), np.asarray(want))


def test_sb_is_the_batch_major_reduce_route_transposed(knobs):
    """The sequence-major plain version is the packed one over the transposed
    rows with the reduce row sum, whatever the knobs say."""
    knobs("exp2i", "mxu")
    qkv, deq, qks, oinv, m2 = _t(*_inputs(24, 3, 4, 16, seed=15))
    got = tms.fused_mha_packed_q3i_sb(qkv, deq, qks, oinv, 4)
    knobs("f32", "reduce")
    want = tms.fused_mha_packed_q3i(qkv.transpose(0, 1).contiguous(), deq, qks, oinv, 4, qk_m2=m2)
    torch.testing.assert_close(got, want.transpose(0, 1), rtol=0, atol=0)


@pytest.mark.parametrize("softmax,rowsum", [("exp2i", "mxu"), ("static", "reduce"),
                                            ("f32", "reduce")])
@pytest.mark.parametrize("split", [False, True], ids=["cls", "cls_split"])
def test_cls_kernels_follow_team_tpus_knobs(knobs, softmax, rowsum, split):
    knobs(softmax, rowsum)
    qkv, deq, qks, oinv, m2 = _inputs(4, 24, 4, 16, seed=16)
    d = 64
    if split:
        q, kv = qkv[:, :1, :d].copy(), qkv[:, :, d:].copy()
        want = jmha.fused_mha_packed_q3i_cls_split(*_j(q, kv, deq, qks, oinv), 4, interpret=True,
                                                   qk_m2=jnp.asarray(m2))
        got = tms.fused_mha_packed_q3i_cls_split(*_t(q, kv, deq, qks, oinv), 4,
                                                 qk_m2=torch.from_numpy(m2))
    else:
        want = jmha.fused_mha_packed_q3i_cls(*_j(qkv, deq, qks, oinv), 4, interpret=True,
                                             qk_m2=jnp.asarray(m2))
        got = tms.fused_mha_packed_q3i_cls(*_t(qkv, deq, qks, oinv), 4, qk_m2=torch.from_numpy(m2))
    assert_within_one_step(got.numpy(), np.asarray(want))
    # static only under TEAM_QI_SOFTMAX=static; the ones-column row sum always
    args = _t(qkv, deq, qks, oinv)
    plain = tms.mha_packed_q3i_reference(*args, 4, qk_m2=torch.from_numpy(m2)
                                         if softmax == "static" else None, rows=1)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)


def test_new_wrappers_on_cpu_count_nothing():
    qkv, deq, qks, oinv, m2 = _t(*_inputs(2, 21, 2, 16, seed=17))
    before = (tms.fused_mha_packed_q3i_cls_split.launches, tms.fused_mha_packed_q3i_sb.launches)
    tms.fused_mha_packed_q3i_cls_split(qkv[:, :1, :32].contiguous(), qkv[:, :, 32:].contiguous(),
                                       deq, qks, oinv, 2, qk_m2=m2)
    tms.fused_mha_packed_q3i_sb(qkv, deq, qks, oinv, 2)
    assert (tms.fused_mha_packed_q3i_cls_split.launches,
            tms.fused_mha_packed_q3i_sb.launches) == before
    tms.fused_mha_packed_q3i_cls_split.launches = tms.fused_mha_packed_q3i_sb.launches = 5
    tms.reset_launch_counts()
    assert tms.fused_mha_packed_q3i_cls_split.launches == tms.fused_mha_packed_q3i_sb.launches == 0


@pytest.mark.parametrize("call,exc", [
    pytest.param(lambda q, kv, a: tms.fused_mha_packed_q3i_cls_split(q.float(), kv, *a),
                 TypeError, id="split-not-int8"),
    pytest.param(lambda q, kv, a: tms.fused_mha_packed_q3i_cls_split(q[:, :, :-4], kv, *a),
                 ValueError, id="split-q-width"),
    pytest.param(lambda q, kv, a: tms.fused_mha_packed_q3i_cls_split(
        torch.cat([q, q], dim=1), kv, *a), ValueError, id="split-q-two-rows"),
    pytest.param(lambda q, kv, a: tms.fused_mha_packed_q3i_cls_split(q[:1], kv, *a),
                 ValueError, id="split-batch"),
    pytest.param(lambda q, kv, a: tms.fused_mha_packed_q3i_cls_split(
        q, kv, a[0][:, :-1], *a[1:]), ValueError, id="split-deq-size"),
    pytest.param(lambda q, kv, a: tms.fused_mha_packed_q3i_cls_split(q, kv.to("meta"), *a),
                 ValueError, id="split-meta-device"),
    pytest.param(lambda q, kv, a: tms.fused_mha_packed_q3i_sb(kv, *a),
                 ValueError, id="sb-not-packed"),
    pytest.param(lambda q, kv, a: tms.fused_mha_packed_q3i_sb(
        torch.cat([kv, q.expand(-1, kv.shape[1], -1)], -1), *a[:3], 3),
                 ValueError, id="sb-heads"),
])
def test_new_wrappers_reject_bad_input(call, exc):
    qkv, deq, qks, oinv, m2 = _t(*_inputs(2, 8, 2, 16, seed=18))
    with pytest.raises(exc):
        call(qkv[:, :1, :32].contiguous(), qkv[:, :, 32:].contiguous(), [deq, qks, oinv, 2])
