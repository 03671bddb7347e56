"""SigLIP So400m/14-384's image tower on the card: the flash kernel at head
width 72 (#14's bf16 instance for SigLIP) against its plain version, and the
27-block tower against the plain reference of the benchmark.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false, as on a CPU-only host. The file imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_siglip_cuda.py

Tolerances: the kernel as #14's bf16 form (2e-2 absolute on unit-normal
inputs, one bf16 step of the output; ``tests/test_torch_cuda.py``); the
tower in bf16 by the benchmark configuration's own limit on the largest
1 − cosine to the reference's bf16 tower over the rows
(``teambench/configs/siglip-so400m14-384-bf16.json``)."""

import json
from pathlib import Path

import pytest
import torch

from card_helpers import record_launches
from team_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference
from team_tpu_torch.utils import phase_timer

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
DH = 72


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _qkv(b, h, s, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((b, h, s, DH), generator=g, device=device).to(torch.bfloat16)
            for _ in range(3)]


def _close(out, ref):
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=2e-2)


@pytest.mark.parametrize("b", [2, 128])
def test_head_width_72_at_siglip_shape(cuda_device, b):
    """B = 2 and the learners' 128, H = 16, S = 729: the tower's blocks, and a
    key mask."""
    q, k, v = _qkv(b, 16, 729, cuda_device, 0)
    for kv_len in (None, 500):
        launches = flash_attention.launches
        out = flash_attention(q, k, v, kv_len)
        torch.cuda.synchronize()
        assert flash_attention.launches == launches + 1
        assert out.dtype == torch.bfloat16 and out.shape == q.shape
        _close(out, flash_attention_reference(q, k, v, kv_len))


@pytest.mark.parametrize("s", [1, 15, 16, 17, 31, 33, 63, 64, 65, 257, 728, 730])
def test_head_width_72_at_ragged_s(cuda_device, s):
    """Query and key tiles whole and ragged by one; every key, one key,
    causal, and causal with kv_len < S."""
    q, k, v = _qkv(2, 2, s, cuda_device, s)
    for causal, kv_len in ((False, None), (False, 1), (True, None), (True, (s + 1) // 2)):
        out = flash_attention(q, k, v, kv_len, causal=causal)
        torch.cuda.synchronize()
        _close(out, flash_attention_reference(q, k, v, kv_len, causal=causal))


def test_head_width_72_on_the_packed_projection(cuda_device):
    """The tower's head views of its ``[B, S, 3·1152]`` qkv (no copy), and
    an unaligned copy of it, which gives the same output bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    b, s, h = 2, 729, 16
    qkv = torch.randn((b, s, 3 * h * DH), generator=g, device=cuda_device).to(torch.bfloat16)

    def views(t):
        return [x.reshape(b, s, h, DH).permute(0, 2, 1, 3) for x in t.split(h * DH, -1)]

    out = flash_attention(*views(qkv))
    _close(out, flash_attention_reference(*views(qkv)))
    assert out.permute(0, 2, 1, 3).is_contiguous()
    buf = torch.empty(qkv.numel() + 16, dtype=qkv.dtype, device=cuda_device)
    start = (16 - buf.data_ptr() % 16) % 16 // 2 + 1
    moved = buf[start:start + qkv.numel()].view(qkv.shape)
    moved.copy_(qkv)
    assert torch.equal(flash_attention(*views(moved)), out)


@pytest.mark.parametrize("b,dh", [(3, 32), (3, 64), (3, 72), (128, 72)])
def test_one_pooling_query_shared_by_the_batch(cuda_device, b, dh):
    """The attention-pool head's form: q ``[B, H, 1, dh]`` with a batch
    stride of 0 over k and v of 729 keys, also at the learners' B=128."""
    g = torch.Generator(device=cuda_device).manual_seed(dh)
    h, s = 16, 729
    q = torch.randn((1, h, 1, dh), generator=g, device=cuda_device).to(torch.bfloat16)
    q = q.expand(b, h, 1, dh)
    k, v = (torch.randn((b, h, s, dh), generator=g, device=cuda_device).to(torch.bfloat16)
            for _ in range(2))
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert out.shape == (b, h, 1, dh)
    _close(out, flash_attention_reference(q, k, v))


def test_float32_head_width_72_is_refused_on_the_card(cuda_device):
    q = torch.zeros((1, 2, 16, DH), device=cuda_device)
    with pytest.raises(ValueError, match="head width 72 not compiled"):
        flash_attention(q, q, q)


def _siglip_cfg():
    return json.loads((ROOT / "teambench/configs/siglip-so400m14-384-bf16.json").read_text())


def test_siglip_tower_matches_the_reference_at_full_width(cuda_device):
    """The 27-block bf16 tower on 2 images of 384 px, through
    ``BackboneRuntime.encode_image``, against the reference's bf16 tower:
    every block's attention on the flash kernel (27 calls, and the head's)."""
    import sys

    sys.path.insert(0, str(ROOT))
    from teambench.drivers import encode_siglip as driver
    from teambench.reference import siglip as reference

    cfg = _siglip_cfg()
    shape = driver.SiglipShape.from_config(cfg)
    params = driver.siglip_params(cfg, 11, cuda_device)
    images = driver.image_pool({"pool_batches": 1, "batch": 2, "images": {"grid": 4, "noise": 24}},
                               shape, 11, cuda_device)[0]
    runtime = driver.program_runtime(cfg["runtime"], params, cuda_device)
    was = phase_timer.enabled()
    phase_timer.enable(True)
    phase_timer.reset()
    try:
        feats = runtime.encode_image(images)
        torch.cuda.synchronize()
        calls = phase_timer.report()["counters"].get(phase_timer.FLASH_CALLS)
    finally:
        phase_timer.enable(was)
        phase_timer.reset()
    assert feats.shape == (2, 1152) and feats.dtype == torch.float32
    assert calls == 28
    del runtime
    ref = reference.features(cfg, params, [images])[0]
    gap = float(driver.worst_gap("feat_cos_gap_max", feats, ref))
    print(f"SigLIP tower, 2 images: largest 1 - cosine {gap:.3e}")
    assert gap <= cfg["check"]["limit"]


def test_siglip_b128_encode_launches_the_tower_kernels(cuda_device, monkeypatch, record_property):
    """One B=128 encode of the 27-block tower through ``BackboneRuntime``:
    ``bias_act`` 58 times (27 qkv, 27 fc with the tanh GELU; the head's q,
    k/v, out-projection and fc), ``residual_ln`` 55 (two a block, the
    head's MLP residual), ``layer_norm`` 3 (the first LN1, ``ln_post``, the
    head's), the flash kernel 28; the features of the composition's tower
    (the kernels switched off) at cosine >= 0.9999: the layer norms'
    one-step differences compound over the blocks to 1 − cosine of about
    1e-5, as far as the composition lies from itself with its layer norm's
    sums in another order (7.7e-6 - 8.0e-6 on three seeds, NVIDIA H100 80GB
    HBM3)."""
    import sys

    sys.path.insert(0, str(ROOT))
    from teambench.drivers import encode_siglip as driver
    from team_tpu_torch.backbone import clip
    from team_tpu_torch.ops import tower_bf16 as ttb

    cfg = _siglip_cfg()
    shape = driver.SiglipShape.from_config(cfg)
    params = driver.siglip_params(cfg, 13, cuda_device)
    images = driver.image_pool({"pool_batches": 1, "batch": 128,
                                "images": {"grid": 4, "noise": 24}}, shape, 13, cuda_device)[0]
    runtime = driver.program_runtime(cfg["runtime"], params, cuda_device)
    counters = (ttb.bias_act, ttb.residual_ln, ttb.layer_norm)

    def encode():
        before = [c.launches for c in counters]
        flash = flash_attention.launches
        out = runtime.encode_image(images)
        torch.cuda.synchronize()
        return out, tuple(c.launches - n for c, n in zip(counters, before)), \
            flash_attention.launches - flash

    feats, counts, flash = encode()
    record_launches(record_property, {"bias_act": counts[0], "residual_ln": counts[1],
                                      "layer_norm": counts[2], "flash_attention": flash})
    assert counts == (58, 55, 3) and flash == 28, (counts, flash)
    monkeypatch.setattr(clip, "_tower_kernels", lambda x, shard=None: False)
    want, counts, flash = encode()
    assert counts == (0, 0, 0) and flash == 28
    cos = torch.nn.functional.cosine_similarity(feats.double(), want.double(), dim=-1).min().item()
    print(f"SigLIP B=128, tower kernels against the composition: min cosine {cos:.7f}")
    assert cos >= 0.9999, cos
