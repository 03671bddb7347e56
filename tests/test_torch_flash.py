"""The port's flash attention against team_tpu's flash kernel.

The plain version (``team_tpu_torch.ops.flash_attention``, what the CPU route
runs and what the CUDA kernel is held to on the card, tests/test_torch_cuda.py)
against ``team_tpu.ops.flash_attention.flash_attention(..., interpret=True)``,
as tests/test_flash_backward.py runs the TPU kernel on the CPU: non-causal,
causal, ``kv_len`` < S, S not a multiple of the TPU's 128-row tile, float32
and bfloat16, from the same numpy inputs. Tolerances: 1e-5 in float32 (the
sums run in another order); one bfloat16 step of the output in bfloat16
(relative 2^-7: both sides compute in float32 and round once).

Then a tiny tower with ``attn_impl="pallas"`` in the port (the plain flash
version on the CPU) against team_tpu's tower at ``xla`` (JAX's ``pallas``
route cannot lower on the CPU without ``interpret``), float32, 1e-5; and the
front end's routes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from team_tpu.backbone import clip as jclip
from team_tpu.ops.flash_attention import flash_attention as jax_flash
from team_tpu_torch.backbone import clip as tclip
from team_tpu_torch.bridge import params_from_numpy
from team_tpu_torch.ops import attention as tattn
from team_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference

BF16_STEP = 2.0 ** -7


def _qkv(seed, b, h, s, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, dh)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,s,dh,causal,kv_len", [
    pytest.param(2, 2, 197, 64, False, None, id="vision"),
    pytest.param(2, 2, 77, 64, True, 77, id="text-causal"),
    pytest.param(1, 3, 150, 32, False, 100, id="kv_len"),
    pytest.param(1, 2, 77, 32, True, 60, id="causal-kv_len"),
    pytest.param(1, 2, 130, 32, False, None, id="ragged-tile"),
])
def test_plain_flash_matches_jax_interpret(dtype, b, h, s, dh, causal, kv_len):
    q, k, v = _qkv(0, b, h, s, dh)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jax_flash(*(jnp.asarray(t, jd) for t in (q, k, v)), kv_len, causal=causal,
                     interpret=True)
    got = flash_attention(*(torch.from_numpy(t).to(td) for t in (q, k, v)), kv_len, causal=causal)
    assert got.dtype == td and got.shape == (b, h, s, dh)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_STEP, atol=1e-6)


def test_flash_takes_strided_views():
    """Head-split views of a packed projection, as the towers pass them."""
    rng = np.random.default_rng(1)
    b, s, h, dh = 2, 33, 3, 32
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * dh)).astype(np.float32))
    views = [t.reshape(b, s, h, dh).permute(0, 2, 1, 3) for t in qkv.split(h * dh, dim=-1)]
    assert not views[0].is_contiguous()
    torch.testing.assert_close(flash_attention(*views, causal=True),
                               flash_attention(*(t.contiguous() for t in views), causal=True),
                               rtol=0, atol=0)


def test_flash_rejects_what_it_does_not_take():
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention(q, q, q, 9)
    with pytest.raises(ValueError, match="shape"):
        flash_attention(q, q, q[:, :, :4])
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())


@pytest.fixture(scope="module")
def tiny_params():
    jp = jclip.init_clip_params(jax.random.PRNGKey(0), jclip.CLIPConfig.tiny())
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def test_tower_through_flash_matches_team_tpu(tiny_params):
    jp, tp = tiny_params
    jcfg, tcfg = jclip.CLIPConfig.tiny(), tclip.CLIPConfig.tiny()
    rng = np.random.default_rng(2)
    images = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    tokens = np.zeros((3, 77), np.int32)
    tokens[:, 0] = 49406
    tokens[:, 1:6] = rng.integers(1, 1000, (3, 5))
    tokens[np.arange(3), [6, 4, 7]] = 49407
    launches = flash_attention.launches
    want_img = jax.jit(functools.partial(jclip.encode_image, cfg=jcfg, attn_impl="xla"))(
        jp, jnp.asarray(images))
    got_img = tclip.encode_image(tp, torch.from_numpy(images), tcfg, attn_impl="pallas")
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=1e-5, atol=1e-5)
    want_txt = jax.jit(functools.partial(jclip.encode_text, cfg=jcfg, attn_impl="xla"))(
        jp, jnp.asarray(tokens))
    got_txt = tclip.encode_text(tp, torch.from_numpy(tokens), tcfg, attn_impl="pallas")
    np.testing.assert_allclose(got_txt.numpy(), np.asarray(want_txt), rtol=1e-5, atol=1e-5)
    assert flash_attention.launches == launches  # the CPU route launches no kernel


def test_front_end_routes(monkeypatch):
    q, k, v = (torch.from_numpy(t) for t in _qkv(3, 1, 2, 16, 32))
    calls = []
    monkeypatch.setattr(tattn, "flash_attention", lambda *a, **kw: calls.append(kw) or a[0])
    tattn.multi_head_attention(q, k, v, impl="pallas", causal=True)
    assert calls == [{"causal": True}]
    tattn.multi_head_attention(q, k, v, impl="auto")  # the CPU: the plain route
    assert len(calls) == 1
    torch.testing.assert_close(tattn.multi_head_attention(q, k, v, impl="auto"),
                               tattn.xla_attention(q, k, v))
    # the pre-split kernel (its plain version here) is non-causal, as team_tpu asserts
    short = []
    monkeypatch.setattr(tattn, "fused_mha_short", lambda *a: short.append(a[3]) or a[0])
    tattn.multi_head_attention(q, k, v, 20, impl="mha_short")
    assert short == [20]
    with pytest.raises(ValueError, match="non-causal"):
        tattn.multi_head_attention(q, k, v, impl="mha_short", causal=True)
    # any other name takes the plain route, as team_tpu's front end does
    torch.testing.assert_close(tattn.multi_head_attention(q, k, v, 20, impl="attn_block"),
                               tattn.xla_attention(q, k, v, 20))
    assert len(calls) == 1 and len(short) == 1


def test_plain_flash_matches_xla_attention_in_float32():
    q, k, v = (torch.from_numpy(t) for t in _qkv(4, 2, 2, 40, 32))
    for causal, kv_len in ((False, None), (True, 30)):
        torch.testing.assert_close(flash_attention_reference(q, k, v, kv_len, causal=causal),
                                   tattn.xla_attention(q, k, v, kv_len, causal=causal),
                                   rtol=1e-5, atol=1e-5)
