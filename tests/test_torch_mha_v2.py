"""Kernel #4: the plain version of ``fused_mha_short_v2`` (deferred softmax
normalisation, ``exp_dtype``) against team_tpu's Pallas kernel in interpret
mode on the CPU, on the same numpy inputs.

Tolerances: float32 inputs 1e-5 absolute (the same arithmetic, sums in
another order; measured 2.4e-7); bfloat16 inputs 2e-2, one bf16 step of
the output as in tests/test_torch_mha_packed.py (an exp one ulp off moves a
bf16-rounded p and so an output by one step; measured 2e-3). ``q_pad`` only
aligns the TPU's rows, so every value gives the port's one result. A bf16
``exp_dtype`` rounds the exponent's argument to bf16 and keeps the exp in
f32, as XLA on the CPU computes it (the check below shows that rounding the
exp's result to bf16 too disagrees with the kernel)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from team_tpu.ops import mha_short as jms
from team_tpu_torch.ops import mha_short as tms

ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(dtype: str, shape=(2, 3, 40, 64), seed=0):
    rng = np.random.default_rng(seed)
    jx = [jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(JDT[dtype])
          for _ in range(3)]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(TDT[dtype]) for a in jx]
    return jx, tx


@pytest.mark.parametrize("kv_len", [None, 29])
@pytest.mark.parametrize("q_pad", [16, 128])
@pytest.mark.parametrize("exp_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v2_plain_version_matches_the_pallas_kernel(dtype, exp_dtype, q_pad, kv_len):
    jx, tx = _inputs(dtype)
    want = np.asarray(jms.fused_mha_short_v2(*jx, kv_len, interpret=True, q_pad=q_pad,
                                             exp_dtype=JDT[exp_dtype]).astype(jnp.float32))
    got = tms.fused_mha_short_v2(*tx, kv_len, exp_dtype=TDT[exp_dtype], q_pad=q_pad)
    assert got.dtype == TDT[dtype] and got.shape == tx[0].shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=ATOL[dtype])


def test_v2_result_does_not_depend_on_q_pad():
    _, tx = _inputs("bfloat16", seed=1)
    outs = [tms.fused_mha_short_v2(*tx, 30, q_pad=p) for p in (1, 16, 128, 333)]
    assert all(torch.equal(o, outs[0]) for o in outs)


def test_v2_differs_from_v1_only_in_the_normalise():
    """v1 rounds p/den to the input dtype before PV, v2 rounds p and divides
    the f32 output: in float32 the two agree to rounding, and in bfloat16 the
    deferred divide moves some outputs by a step."""
    _, t32 = _inputs("float32", seed=2)
    np.testing.assert_allclose(tms.fused_mha_short_v2(*t32).numpy(),
                               tms.fused_mha_short(*t32).numpy(), rtol=0, atol=1e-6)
    _, t16 = _inputs("bfloat16", seed=2)
    assert not torch.equal(tms.fused_mha_short_v2(*t16), tms.fused_mha_short(*t16))


def test_bf16_exp_keeps_the_exponential_in_float32():
    jx, tx = _inputs("float32", seed=3)
    want = np.asarray(jms.fused_mha_short_v2(*jx, interpret=True, exp_dtype=jnp.bfloat16))
    q, k, v = tx
    logits = (q * 64 ** -0.5) @ k.transpose(-1, -2)
    p = torch.exp((logits - logits.amax(-1, keepdim=True)).to(torch.bfloat16)).float()
    rounded = p.to(torch.bfloat16).float()  # the exp's result rounded to bf16 as well
    wrong = (rounded @ v) / rounded.sum(-1, keepdim=True)
    assert np.abs(wrong.numpy() - want).max() > 1e-4
    np.testing.assert_allclose(tms.mha_short_v2_reference(q, k, v, None, torch.bfloat16).numpy(),
                               want, rtol=0, atol=ATOL["float32"])


def test_v2_wrapper_rejects_what_it_does_not_take():
    _, (q, k, v) = _inputs("float32")
    with pytest.raises(ValueError):
        tms.fused_mha_short_v2(q, k, v, q_pad=0)
    with pytest.raises(ValueError):
        tms.fused_mha_short_v2(q, k, v, 0)
    with pytest.raises(TypeError):
        tms.fused_mha_short_v2(q, k, v, exp_dtype=torch.float16)
    with pytest.raises(TypeError):
        tms.fused_mha_short_v2(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        tms.fused_mha_short_v2(q, k[:, :, :10], v)
