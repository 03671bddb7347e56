"""The backwards of the differentiable kernels #1 ``fused_mha_packed``, #3
``fused_mha_short``, #13 ``fused_attn_block`` and #14 ``flash_attention``
against ``jax.grad`` of team_tpu's kernels, run in interpret mode as
tests/test_flash_backward.py runs them.

The port's wrappers are called on CPU tensors that require grad, so they go
through their ``torch.autograd.Function``: the forward is the plain version
and the backward is the rule under test (a recompute of the plain attention
in the kernel's layout, as team_tpu's custom VJPs do). The loss is
``sum(tanh(out) · w)`` for a fixed w, so the cotangent depends on the
forward. float32; tolerance 1e-4 absolute and relative, as
tests/test_flash_backward.py holds team_tpu's backwards to its XLA
reference. On the card ``chip_smoke.py`` phase 3 holds the kernels'
gradients to autograd of the plain references, f32 and bf16.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from team_tpu.ops import mha_short as jms
from team_tpu.ops.flash_attention import flash_attention as jax_flash
from team_tpu_torch.ops import _grad
from team_tpu_torch.ops import flash_attention as tfa
from team_tpu_torch.ops import mha_short as tms

TOL = dict(atol=1e-4, rtol=1e-4)


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def _torch_grads(fn, arrays, w):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*leaves)
    assert out.grad_fn is not None and "Fn" in type(out.grad_fn).__name__  # the Function
    loss = (torch.tanh(out) * torch.from_numpy(w)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _jax_grads(fn, arrays, w):
    def loss(*xs):
        return jnp.sum(jnp.tanh(fn(*xs)) * w)

    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))]


def _assert_grads(got, want, names):
    for g, w_, name in zip(got, want, names):
        np.testing.assert_allclose(g, w_, err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("causal,kv_len", [(False, None), (True, None), (False, 15)])
def test_packed_backward_matches_team_tpu(causal, kv_len):
    b, h, s, d = 2, 2, 21, 16
    (qkv,) = _arrays(0, (b, s, 3 * d))
    (w,) = _arrays(1, (b, s, d))
    got = _torch_grads(lambda t: tms.fused_mha_packed(t, h, causal=causal, kv_len=kv_len),
                       [qkv], w)
    want = _jax_grads(lambda t: jms.fused_mha_packed(t, h, causal=causal, kv_len=kv_len,
                                                     interpret=True), [qkv], w)
    _assert_grads(got, want, ["qkv"])
    if kv_len is not None:  # padded keys take no gradient
        assert np.abs(got[0][:, kv_len:, d:]).max() == 0.0


@pytest.mark.parametrize("kv_len", [64, 40])
def test_short_backward_matches_team_tpu(kv_len):
    q, k, v = _arrays(2, *[(1, 2, 64, 16)] * 3)
    (w,) = _arrays(3, (1, 2, 64, 16))
    got = _torch_grads(lambda a, b, c: tms.fused_mha_short(a, b, c, kv_len), [q, k, v], w)
    want = _jax_grads(lambda a, b, c: jms.fused_mha_short(a, b, c, kv_len, interpret=True),
                      [q, k, v], w)
    _assert_grads(got, want, "qkv")


@pytest.mark.parametrize("causal", [False, True])
def test_attn_block_backward_matches_team_tpu(causal):
    """Gradients to every input team_tpu returns one for: x, the layer-norm
    affine, both weights and both biases (all non-trivial)."""
    b, h, s, d = 2, 2, 21, 16
    x, lng, lnb, wqkv, bqkv, wout, bout = _arrays(4, (b, s, d), (d,), (d,), (d, 3 * d), (3 * d,),
                                                  (d, d), (d,))
    lng = 1.0 + 0.3 * lng
    wqkv, wout = 0.2 * wqkv, 0.2 * wout
    bqkv, bout, lnb = 0.5 * bqkv, 0.5 * bout, 0.2 * lnb
    (w,) = _arrays(5, (b, s, d))
    arrays = [x, lng, lnb, wqkv, bqkv, wout, bout]
    got = _torch_grads(lambda *a: tms.fused_attn_block(*a, h, causal=causal), arrays, w)
    want = _jax_grads(lambda *a: jms.fused_attn_block(*a, h, causal=causal, interpret=True),
                      arrays, w)
    _assert_grads(got, want, ["x", "ln_scale", "ln_bias", "qkv_w", "qkv_b", "out_w", "out_b"])


@pytest.mark.parametrize("causal,kv_len", [(False, 512), (True, 512), (False, 400)])
def test_flash_backward_matches_team_tpu(causal, kv_len):
    q, k, v = _arrays(6, *[(1, 2, 512, 64)] * 3)
    (w,) = _arrays(7, (1, 2, 512, 64))
    got = _torch_grads(lambda a, b, c: tfa.flash_attention(a, b, c, kv_len, causal=causal),
                       [q, k, v], w)
    want = _jax_grads(functools.partial(_jax_flash, kv_len=kv_len, causal=causal), [q, k, v], w)
    _assert_grads(got, want, "qkv")
    if kv_len < 512:
        assert np.abs(got[1][:, :, kv_len:]).max() < 1e-6
        assert np.abs(got[2][:, :, kv_len:]).max() < 1e-6


def _jax_flash(q, k, v, kv_len, causal):
    return jax_flash(q, k, v, kv_len, causal=causal, interpret=True)


def test_inference_takes_no_function_and_saves_nothing():
    """Without grad the wrappers return the plain version's tensor itself,
    as before (on the card: the same launches, no saved tensors)."""
    (qkv,) = _arrays(8, (1, 9, 24))
    t = torch.from_numpy(qkv)
    out = tms.fused_mha_packed(t, 2)
    assert out.grad_fn is None
    with torch.no_grad():
        assert tms.fused_mha_packed(t.requires_grad_(True), 2).grad_fn is None
    torch.testing.assert_close(out, tms.mha_packed_reference(t.detach(), 2), rtol=0, atol=0)


def test_refuse_grad_names_the_route():
    t = torch.ones(2, requires_grad=True)
    assert _grad.wants_grad(t) and not _grad.wants_grad(t.detach(), None, 3)
    with pytest.raises(RuntimeError, match="fused_mha_packed_proj \\(#12\\)"):
        _grad.refuse_grad("fused_mha_packed_proj (#12)", t)
    with torch.no_grad():
        assert not _grad.wants_grad(t)
        _grad.refuse_grad("fused_mha_packed_proj (#12)", t)


def test_backward_references_are_team_tpus():
    """What the backwards recompute equals team_tpu's ``_xla_packed_reference``
    and ``_xla_attn_block_reference`` in the forward too (f32, 1e-5)."""
    b, h, s, d = 2, 2, 21, 16
    (qkv,) = _arrays(9, (b, s, 3 * d))
    for causal, kv_len in ((False, None), (True, None), (False, 11)):
        got = tms.mha_packed_backward_reference(torch.from_numpy(qkv), h, causal, kv_len)
        want = jms._xla_packed_reference(jnp.asarray(qkv), h, causal, kv_len)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    arrays = _arrays(10, (b, s, d), (d,), (d,), (d, 3 * d), (3 * d,), (d, d), (d,))
    got = tms.attn_block_backward_reference(*(torch.from_numpy(a) for a in arrays), h, True)
    want = jms._xla_attn_block_reference(*(jnp.asarray(a) for a in arrays), h, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
