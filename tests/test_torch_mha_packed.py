"""Packed attention: the port's plain version against the JAX Pallas kernel
(interpret mode, as tests/test_backbone.py runs it on the CPU), and the
wrapper's checks. The CUDA kernel is held against the plain version on the
card in tests/test_torch_cuda.py.

Tolerances: float32 1e-5 (both accumulate in f32, in another order);
bfloat16 2e-2 absolute (q and p are rounded to bf16 on both sides, and a
rounding that lands on the other side of a bf16 step moves p by 2^-8)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from team_tpu.ops.mha_short import fused_mha_packed as jax_fused_mha_packed
from team_tpu_torch.ops.mha_short import fused_mha_packed, mha_packed_reference

# (batch, seq, heads, head width, causal, kv_len)
CASES = [
    pytest.param(2, 37, 4, 8, False, None, id="noncausal"),
    pytest.param(2, 21, 2, 8, True, None, id="causal"),
    pytest.param(2, 37, 4, 8, False, 30, id="kvlen"),
    pytest.param(2, 21, 2, 8, True, 15, id="causal-kvlen"),
    pytest.param(1, 197, 12, 64, False, None, id="vision-full-width"),
    pytest.param(1, 77, 8, 64, True, None, id="text-full-width"),
]


def _qkv(b, s, h, dh, seed=0):
    return np.random.default_rng(seed).standard_normal((b, s, 3 * h * dh)).astype(np.float32)


@pytest.mark.parametrize("b,s,h,dh,causal,kv_len", CASES)
def test_reference_matches_jax_kernel_f32(b, s, h, dh, causal, kv_len):
    x = _qkv(b, s, h, dh)
    want = np.asarray(jax_fused_mha_packed(jnp.asarray(x), h, causal=causal, kv_len=kv_len,
                                           interpret=True))
    got = mha_packed_reference(torch.from_numpy(x), h, causal, kv_len).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,s,h,dh,causal,kv_len", CASES)
def test_reference_matches_jax_kernel_bf16(b, s, h, dh, causal, kv_len):
    x = _qkv(b, s, h, dh, seed=1)
    want = jax_fused_mha_packed(jnp.asarray(x).astype(jnp.bfloat16), h, causal=causal,
                                kv_len=kv_len, interpret=True)
    assert want.dtype == jnp.bfloat16
    got = mha_packed_reference(torch.from_numpy(x).to(torch.bfloat16), h, causal, kv_len)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=2e-2)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    x = torch.from_numpy(_qkv(2, 21, 2, 8))
    before = (fused_mha_packed.launches, fused_mha_packed.causal_launches)
    out = fused_mha_packed(x, 2, causal=True, kv_len=17)
    torch.testing.assert_close(out, mha_packed_reference(x, 2, True, 17), rtol=0, atol=0)
    assert (fused_mha_packed.launches, fused_mha_packed.causal_launches) == before


@pytest.mark.parametrize("shape,heads,kw,exc", [
    pytest.param((2, 5, 10), 2, {}, ValueError, id="not-packed"),
    pytest.param((2, 5, 12), 3, {}, ValueError, id="heads-do-not-divide"),
    pytest.param((2, 5, 12), 2, {"kv_len": 0}, ValueError, id="kv_len-zero"),
    pytest.param((2, 5, 12), 2, {"kv_len": 6}, ValueError, id="kv_len-past-seq"),
])
def test_wrapper_rejects_bad_input(shape, heads, kw, exc):
    with pytest.raises(exc):
        fused_mha_packed(torch.zeros(shape), heads, **kw)


def test_wrapper_rejects_dtype_and_device():
    with pytest.raises(TypeError):
        fused_mha_packed(torch.zeros((1, 4, 12), dtype=torch.float16), 2)
    with pytest.raises(ValueError):
        fused_mha_packed(torch.zeros((1, 4, 12), device="meta"), 2)
