"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false, as on a CPU-only host. The file imports no jax, so on the machine with
the card it runs without the JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float32 1e-5 (the kernel sums in another order than cuBLAS);
bfloat16 2e-2 (one bf16 step of the output, as in tests/test_torch_mha_packed.py)."""

import pytest
import torch

from team_tpu_torch.backbone import clip as tclip
from team_tpu_torch.ops.mha_short import fused_mha_packed, mha_packed_reference

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
