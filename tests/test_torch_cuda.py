"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false, as on a CPU-only host. The file imports no jax, so on the machine with
the card it runs without the JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float32 1e-5 (the kernel sums in another order than cuBLAS);
bfloat16 2e-2 (one bf16 step of the output, as in tests/test_torch_mha_packed.py);
the int8 integer-QKᵀ kernels at most one int8 step with under 1 % of the
outputs differing (as in tests/test_torch_mha_q3i.py); the int8 tower
through them cosine >= 0.9999 and max |Δ| <= 5e-3·rms against the CPU."""

import pytest
import torch

from team_tpu_torch.backbone import clip as tclip
from team_tpu_torch.backbone import quant as tquant
from team_tpu_torch.bridge import tree_to
from team_tpu_torch.ops.mha_short import (fused_mha_packed, fused_mha_packed_q3i,
                                          fused_mha_packed_q3i_cls, mha_packed_q3i_reference,
                                          mha_packed_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,causal,kv_len", [
    (128, 197, 12, False, None), (32, 77, 8, True, None), (4, 197, 12, False, 150),
    (4, 77, 8, True, 60), (3, 37, 4, False, None)])
def test_mha_packed_kernel_matches_plain_version(cuda_device, dtype, atol, b, s, h, causal, kv_len):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((b, s, 3 * h * 64), generator=g, device=cuda_device).to(dtype)
    launches = fused_mha_packed.launches
    out = fused_mha_packed(x, h, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert fused_mha_packed.launches == launches + 1
    assert out.dtype == dtype and out.shape == (b, s, h * 64)
    torch.testing.assert_close(out.float(), mha_packed_reference(x, h, causal, kv_len).float(),
                               rtol=0, atol=atol)


def test_towers_through_the_kernel_match_plain_attention(cuda_device):
    cfg = tclip.CLIPConfig.tiny()  # head width 32
    params = tclip.cast_frozen_params(
        tclip.init_clip_params(torch.Generator().manual_seed(0), cfg), torch.float32, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    images = torch.randn((4, 32, 32, 3), generator=g, device=cuda_device)
    tokens = torch.randint(1, 1000, (4, 77), generator=g, device=cuda_device)
    launches = fused_mha_packed.launches
    img = tclip.encode_image(params, images, cfg, attn_impl="auto")
    txt = tclip.encode_text(params, tokens, cfg, attn_impl="auto")
    assert fused_mha_packed.launches == launches + cfg.vision.layers + cfg.text.layers
    torch.testing.assert_close(img, tclip.encode_image(params, images, cfg, attn_impl="xla"),
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(txt, tclip.encode_text(params, tokens, cfg, attn_impl="xla"),
                               rtol=1e-4, atol=1e-5)


def test_mha_packed_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros((2, 8, 3 * 64), device=cuda_device)
    with pytest.raises(ValueError, match="head width"):
        fused_mha_packed(x, 4)  # dh = 16
    with pytest.raises(ValueError, match="contiguous"):
        fused_mha_packed(torch.zeros((2, 3 * 128, 8), device=cuda_device).transpose(1, 2), 2)
    with pytest.raises(ValueError, match="shared memory"):
        fused_mha_packed(torch.zeros((1, 2048, 3 * 64), device=cuda_device), 1)


def q3i_inputs(b, s, heads, device, seed=0, dh=64):
    """int8 qkv and scales in the ranges of tests/test_torch_mha_q3i.py."""
    g = torch.Generator(device=device).manual_seed(seed)
    d = heads * dh

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo

    qkv = torch.randint(-127, 128, (b, s, 3 * d), generator=g, device=device, dtype=torch.int8)
    return (qkv, uniform((1, 3 * d), 0.01, 0.03), uniform((1, heads), 1e-4, 3e-4) * 4 / dh ** 0.5,
            uniform((1, d), 20, 60), uniform((1, heads), 3, 6))


def assert_within_one_int8_step(got, want):
    assert got.dtype == want.dtype == torch.int8 and got.shape == want.shape
    diff = (got.int() - want.int()).abs()
    assert diff.max().item() <= 1, diff.max().item()
    assert (diff > 0).float().mean().item() < 0.01


@pytest.mark.parametrize("b,s,h,causal,kv_len,static", [
    (128, 197, 12, False, None, True), (128, 197, 12, False, None, False),
    (32, 77, 8, True, None, False), (4, 197, 12, False, 150, False),
    (4, 77, 8, True, 60, False), (3, 37, 4, False, None, True)])
def test_q3i_kernel_matches_plain_version(cuda_device, b, s, h, causal, kv_len, static):
    qkv, deq, qks, oinv, m2 = q3i_inputs(b, s, h, cuda_device)
    m2 = m2 if static else None
    launches = fused_mha_packed_q3i.launches
    out = fused_mha_packed_q3i(qkv, deq, qks, oinv, h, causal=causal, kv_len=kv_len, qk_m2=m2)
    torch.cuda.synchronize()
    assert fused_mha_packed_q3i.launches == launches + 1
    assert_within_one_int8_step(out, mha_packed_q3i_reference(qkv, deq, qks, oinv, h, causal,
                                                              kv_len, m2))


@pytest.mark.parametrize("b,s,h", [(128, 197, 12), (3, 37, 4)])
@pytest.mark.parametrize("static", [True, False])
def test_q3i_cls_kernel_matches_plain_version_and_row0(cuda_device, b, s, h, static):
    qkv, deq, qks, oinv, m2 = q3i_inputs(b, s, h, cuda_device, seed=1)
    m2 = m2 if static else None
    launches = fused_mha_packed_q3i_cls.launches
    out = fused_mha_packed_q3i_cls(qkv, deq, qks, oinv, h, qk_m2=m2)
    torch.cuda.synchronize()
    assert fused_mha_packed_q3i_cls.launches == launches + 1
    assert_within_one_int8_step(out, mha_packed_q3i_reference(qkv, deq, qks, oinv, h, qk_m2=m2,
                                                              rows=1))
    full = fused_mha_packed_q3i(qkv, deq, qks, oinv, h, qk_m2=m2)[:, :1].contiguous()
    assert_within_one_int8_step(out, full)


def test_int8_tower_through_the_kernels_matches_plain_attention(cuda_device, monkeypatch):
    """Tiny int8 tower on the card (head width 32; the CLS rows of the last
    block take torch._int_mm's row padding) through the kernels, against the
    same tower on the card with the plain attention versions."""
    cfg = tclip.CLIPConfig.tiny()
    params = tree_to(tclip.init_clip_params(torch.Generator().manual_seed(0), cfg), cuda_device)
    images = torch.randn((4, 32, 32, 3), generator=torch.Generator().manual_seed(1)).to(cuda_device)
    stats = tquant.calibrate_vision_tower(params, images, cfg)
    qv = tquant.quantize_vision_tower_static(params, stats, heads=cfg.vision.heads)
    before = (fused_mha_packed_q3i.launches, fused_mha_packed_q3i_cls.launches)
    got = tquant.encode_image_int8(qv, images, cfg).double()
    assert (fused_mha_packed_q3i.launches - before[0],
            fused_mha_packed_q3i_cls.launches - before[1]) == (cfg.vision.layers - 1, 1)
    monkeypatch.setattr(tquant, "fused_mha_packed_q3i",
                        lambda qkv, deq, qks, oinv, h, qk_m2=None, **kw:
                        mha_packed_q3i_reference(qkv, deq, qks, oinv, h, qk_m2=qk_m2))
    monkeypatch.setattr(tquant, "fused_mha_packed_q3i_cls",
                        lambda qkv, deq, qks, oinv, h, qk_m2=None:
                        mha_packed_q3i_reference(qkv, deq, qks, oinv, h, qk_m2=qk_m2, rows=1))
    want = tquant.encode_image_int8(qv, images, cfg).double()
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).min().item()
    err = (got - want).abs().max().item()
    rms = want.pow(2).mean().sqrt().item()
    assert cos >= 0.9999 and err <= 5e-3 * rms + 1e-6, (cos, err, rms)


def test_q3i_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    qkv, deq, qks, oinv, m2 = q3i_inputs(2, 8, 4, cuda_device, dh=16)
    with pytest.raises(ValueError, match="head width"):
        fused_mha_packed_q3i(qkv, deq, qks, oinv, 4)
    qkv, deq, qks, oinv, m2 = q3i_inputs(1, 2048, 1, cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        fused_mha_packed_q3i(qkv, deq, qks, oinv, 1)
    with pytest.raises(ValueError, match="lies on"):
        fused_mha_packed_q3i(qkv, deq.cpu(), qks, oinv, 1)
