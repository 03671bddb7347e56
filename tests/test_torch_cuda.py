"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false, as on a CPU-only host. The file imports no jax, so on the machine with
the card it runs without the JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float32 1e-5 (the kernel sums in another order than cuBLAS);
bfloat16 2e-2 (one bf16 step of the output, as in tests/test_torch_mha_packed.py);
the int8 integer-QKᵀ kernels at most one int8 step with under 1 % of the
outputs differing (as in tests/test_torch_mha_q3i.py); the int8 tower
through them cosine >= 0.9999 and max |Δ| <= 5e-3·rms against the CPU; the
flash kernel as the packed one (f32 1e-5, bf16 2e-2); the int8-I/O attention
kernels and the layer norm -> int8 kernel at most one int8 step with under
1 % of the outputs differing (as in tests/test_torch_int8_static.py), the
static quantize kernel bit for bit; the tower on each static route through
its kernels against the same tower with the plain versions, cosine >= 0.9999
and max |Δ| <= 5e-3·rms; the pre-split kernel as the packed one; the fused
out-projection and attention sub-block kernels float32 1e-5 and bfloat16
2e-2 plus one bf16 step (2^-7) of the output's magnitude (the residual
makes outputs up to ~5, where one step is 0.03), their bf16 tensor-core
forms at the tile edges, the longest S, with float32 weights and unaligned
inputs to the same limit; the integer-QKᵀ kernel's
other modes (``exp2i``, ``reduce``, ``defer_norm``, ``pv_int8``) and its
sequence-major entry as its default one (``pv_int8``: plus what one
p8 = rint(p·127) across a rounding edge moves an output by, up to
deq_v·o_inv steps), the split CLS entry equal to the packed CLS entry bit for
bit; the tower on the sequence-major, flat-batch,
int8-PV, CLS-mode, knob and ``xla`` routes as on the static routes; the int8
GEMM kernels against their plain versions, float32 1e-5 of the output's
largest magnitude (the tanh from another library; without the GELU the
same products in the same order) and bfloat16 one bf16 step (2^-7) of the
output, ``gelu_quant`` and the dynamic layer norm -> int8 kernel to one int8
step on under 1 % of the outputs with scales within 1e-6 relative, the 3-D
static producer bit for bit the 2-D one; the image and text towers on the
``hybrid`` and ``pallas`` tiers as on the static routes; the head-split
kernels, each rank as its whole-head kernel against the plain version, and
the ranks side by side equal to the whole-head kernel bit for bit; the v2
pre-split kernel (f32 1e-5, bf16 one output step, 2^-7 of |ref|, plus
1e-5; at the vision batch and on the shoot-out probe's own inputs two bf16
steps of |ref| plus one of the row's largest, ``assert_within_bf16_steps``),
its deferred normalise and bf16 exp each shown to take effect; the q3i
decomposition variants at most one int8 step on under 1 % of the outputs
(``copy`` bit for bit, ``full`` bit for bit the packed q3i kernel with unit
v scales); the u8 normalize bit for bit; the bicubic resize on the card
within 1e-5 of the CPU; the GEMM probes' kernels (``ops/gemm_probe.py``):
int8 ``probe_mm`` and ``mxu_ceiling`` bit for bit, their bf16 forms within
``probe_mm_bf16_limit`` and ``CEILING_BF16_SHARE`` of the largest |ref|, the
MLP megakernel within ``mlp_mega_limit`` (bit for bit on rows with no hq
near a rounding edge) and its 2-D and 3-D entries equal bit for bit, also
on the probes' own inputs; ``probe_mm``'s wgmma bf16 form at the tile edges
within ``probe_mm_bf16_limit``; the
tensor-core forms of the packed and flash kernels at their tile edges, the
longest S, with key masks and unaligned inputs, as the packed and flash
kernels (bf16 2e-2), the pre-split and head-split entries equal to the
packed one bit for bit, and an unaligned input's output equal to the
aligned one's bit for bit; the int8 attention's tensor-core kernels at
their tile edges to the int8 limits above, and bit for bit the plain
version on inputs whose softmax sums are exact in any order; the static
tower's epilogues at its vision, CLS-row, text and ``kqs`` shapes against
the compositions they replace, ``static_requant`` without an activation and
``static_residual`` bit for bit, ``static_requant`` with a GELU and
``ln_quant_folded`` at most one int8 step on under 0.1 % of the outputs, a
12-layer ``static3d_qi`` tower launching each of them 24 times an encode
(25 requantizes under ``kqs``) within the tower limits above of the same
tower with the compositions; and in the SASS of each source
(``tests/sass_tables.py``) the tensor-core kernels' HMMA, GMMA and IMMA, the
CUDA-core and mma.sync kernels' none, and no spill in ptxas's report."""

import math
import re

import pytest
import torch

import sass_tables
from card_helpers import pv_int8_limit, record_launches

from team_tpu_torch.backbone import clip as tclip
from team_tpu_torch.backbone import quant as tquant
from team_tpu_torch.bridge import tree_to
from team_tpu_torch.ops import int8_matmul as tim
from team_tpu_torch.ops import mha_short as tms
from team_tpu_torch.ops.flash_attention import build as flash_build
from team_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference
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
    (4, 77, 8, True, 60), (32, 197, 12, False, 150), (32, 77, 8, True, 60),
    (3, 37, 4, False, None)])
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


def assert_within_one_int8_step(got, want, limit: int = 1):
    assert got.dtype == want.dtype == torch.int8 and got.shape == want.shape
    diff = (got.int() - want.int()).abs()
    assert diff.max().item() <= limit, diff.max().item()
    assert (diff > 0).float().mean().item() < 0.01


@pytest.mark.parametrize("b,s,h,causal,kv_len,static", [
    (128, 197, 12, False, None, True), (128, 197, 12, False, None, False),
    (32, 77, 8, True, None, False), (4, 197, 12, False, 150, False),
    (4, 77, 8, True, 60, False), (32, 197, 12, False, 150, False), (32, 77, 8, True, 60, False),
    (3, 37, 4, False, None, True)])
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
    monkeypatch.setattr(tquant, "fused_mha_packed_q3i_tp",
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


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,h,s,dh,causal,kv_len", [
    (128, 12, 197, 64, False, None), (32, 8, 77, 64, True, 77), (8, 12, 577, 64, False, None),
    (3, 4, 37, 32, False, 20), (2, 2, 130, 32, True, 100)])
def test_flash_kernel_matches_plain_version(cuda_device, dtype, atol, b, h, s, dh, causal, kv_len):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((b, h, s, dh), generator=g, device=cuda_device).to(dtype)
               for _ in range(3))
    launches = flash_attention.launches
    out = flash_attention(q, k, v, kv_len, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    assert out.dtype == dtype and out.shape == (b, h, s, dh)
    torch.testing.assert_close(out.float(),
                               flash_attention_reference(q, k, v, kv_len, causal=causal).float(),
                               rtol=0, atol=atol)


def test_flash_kernel_takes_head_split_views(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    b, s, h, dh = 4, 77, 8, 64
    qkv = torch.randn((b, s, 3 * h * dh), generator=g, device=cuda_device)
    q, k, v = (t.reshape(b, s, h, dh).permute(0, 2, 1, 3) for t in qkv.split(h * dh, dim=-1))
    out = flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(out, flash_attention_reference(q, k, v, causal=True),
                               rtol=0, atol=1e-5)
    assert out.permute(0, 2, 1, 3).is_contiguous()  # heads merge back without a copy


def test_towers_through_flash_match_plain_attention(cuda_device):
    cfg = tclip.CLIPConfig.tiny()  # head width 32
    params = tclip.cast_frozen_params(
        tclip.init_clip_params(torch.Generator().manual_seed(0), cfg), torch.float32, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    images = torch.randn((4, 32, 32, 3), generator=g, device=cuda_device)
    tokens = torch.randint(1, 1000, (4, 77), generator=g, device=cuda_device)
    launches, causal = flash_attention.launches, flash_attention.causal_launches
    img = tclip.encode_image(params, images, cfg, attn_impl="pallas")
    txt = tclip.encode_text(params, tokens, cfg, attn_impl="pallas")
    assert flash_attention.launches - launches == 4 and flash_attention.causal_launches - causal == 2
    torch.testing.assert_close(img, tclip.encode_image(params, images, cfg, attn_impl="xla"),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(txt, tclip.encode_text(params, tokens, cfg, attn_impl="xla"),
                               rtol=1e-5, atol=1e-5)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    q = torch.zeros((1, 2, 16, 48), device=cuda_device)
    with pytest.raises(ValueError, match="head width"):
        flash_attention(q, q, q)
    q = torch.zeros((1, 2, 64, 16), device=cuda_device).transpose(-1, -2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, q, q)



# -- the int8 tier's other static routes: int8-I/O attention and the producers --

def packed_q_inputs(b, s, heads, device, seed=0, dh=64):
    """int8 qkv and per-channel scales in the ranges of tests/test_torch_int8_static.py."""
    g = torch.Generator(device=device).manual_seed(seed)
    d = heads * dh
    qkv = torch.randint(-127, 128, (b, s, 3 * d), generator=g, device=device, dtype=torch.int8)
    deq = torch.rand((1, 3 * d), generator=g, device=device) * 0.02 + 0.01
    return qkv, deq, torch.rand((1, d), generator=g, device=device) * 40 + 20


@pytest.mark.parametrize("form", ["q", "q3"])
@pytest.mark.parametrize("b,s,h,causal,kv_len", [
    (128, 197, 12, False, None), (4, 197, 12, False, 150), (32, 77, 8, True, None),
    (4, 77, 8, True, 60), (32, 197, 12, False, 150), (32, 77, 8, True, 60),
    (3, 37, 4, False, None)])
def test_packed_q_kernels_match_plain_version(cuda_device, form, b, s, h, causal, kv_len):
    qkv, deq, oinv = packed_q_inputs(b, s, h, cuda_device)
    want = tms.mha_packed_q_reference(qkv, deq, oinv, h, causal, kv_len, bf16_deq=form == "q3")
    wrapper = tms.fused_mha_packed_q if form == "q" else tms.fused_mha_packed_q3
    launches = wrapper.launches
    if form == "q":
        out = wrapper(qkv.reshape(b * s, -1), deq, oinv, h, seq=s, causal=causal,
                      kv_len=kv_len).reshape(b, s, -1)
    else:
        out = wrapper(qkv, deq, oinv, h, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert wrapper.launches == launches + 1
    assert_within_one_int8_step(out, want)


def producer_inputs(m, d, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn((m, d), generator=g, device=device)
         * (torch.rand((m, 1), generator=g, device=device) * 3.5 + 0.5)).to(torch.bfloat16)
    gamma = torch.rand(d, generator=g, device=device) + 0.5
    beta = torch.rand(d, generator=g, device=device) * 0.4 - 0.2
    return x, gamma, beta, torch.rand((1, d), generator=g, device=device) * 50 + 10


@pytest.mark.parametrize("m,d", [(128 * 197, 768), (16 * 197 + 5, 768), (37, 64), (9, 1024)])
def test_quantize_producer_kernels_match_plain_versions(cuda_device, m, d):
    x, gamma, beta, inv_a = producer_inputs(m, d, cuda_device)
    launches = (tim.ln_quantize_static.launches, tim.row_quant_static.launches)
    ln = tim.ln_quantize_static(x, gamma, beta, inv_a)
    row = tim.row_quant_static(x, inv_a)
    torch.cuda.synchronize()
    assert (tim.ln_quantize_static.launches, tim.row_quant_static.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert_within_one_int8_step(ln, tim.ln_quantize_static_reference(x, gamma, beta, inv_a))
    torch.testing.assert_close(row, tim.row_quant_static_reference(x, inv_a), rtol=0, atol=0)


def test_int8_io_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    qkv, deq, oinv = packed_q_inputs(2, 8, 4, cuda_device, dh=32)
    with pytest.raises(ValueError, match="head width"):
        tms.fused_mha_packed_q3(qkv, deq, oinv, 4)
    qkv, deq, oinv = packed_q_inputs(2, 8, 2, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        tms.fused_mha_packed_q3(qkv.transpose(0, 1), deq, oinv, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tms.fused_mha_packed_q(qkv.reshape(16, -1)[::2], deq, oinv, 2, seq=8)
    with pytest.raises(TypeError):
        tms.fused_mha_packed_q3(qkv.float(), deq, oinv, 2)
    x, gamma, beta, inv_a = producer_inputs(8, 64, cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        tim.ln_quantize_static(x.float(), gamma, beta, inv_a)
    with pytest.raises(TypeError, match="bfloat16"):
        tim.row_quant_static(x.float(), inv_a)
    with pytest.raises(ValueError, match="contiguous"):
        tim.row_quant_static(x.t(), inv_a[:, :8])
    with pytest.raises(ValueError, match="divisible by 8"):
        tim.row_quant_static(x[:, :60].contiguous(), inv_a[:, :60])
    x, gamma, beta, inv_a = producer_inputs(8, 2048, cuda_device)
    with pytest.raises(ValueError, match="wider"):
        tim.ln_quantize_static(x, gamma, beta, inv_a)


STATIC_ROUTES = ("static", "static_qa", "static3d", "static3d_qa", "static3d_qaf")


def plain_int8_kernels(monkeypatch):
    """Send the int8 tower's kernels to their plain versions (same card)."""
    plain_epilogues(monkeypatch)
    monkeypatch.setattr(tquant, "ln_quantize_static", tim.ln_quantize_static_reference)
    monkeypatch.setattr(tquant, "row_quant_static", tim.row_quant_static_reference)
    monkeypatch.setattr(tquant, "attention_core", lambda qkv, heads, *, causal, kv_len, impl:
                        mha_packed_reference(qkv, heads, causal, kv_len))
    monkeypatch.setattr(tquant, "fused_mha_packed_q",
                        lambda qkv, deq, oinv, h, *, seq, causal=False, kv_len=None:
                        tms.mha_packed_q_reference(qkv.reshape(-1, seq, qkv.shape[-1]), deq, oinv,
                                                   h, causal, kv_len).reshape(qkv.shape[0], -1))
    monkeypatch.setattr(tquant, "fused_mha_packed_q3",
                        lambda qkv, deq, oinv, h, *, causal=False, kv_len=None:
                        tms.mha_packed_q_reference(qkv, deq, oinv, h, causal, kv_len,
                                                   bf16_deq=True))


def test_static_routes_through_the_kernels_match_plain_versions(cuda_device, monkeypatch):
    """A two-layer tower of head width 64 (one head of 64) on the card, each
    static route through its kernels, against the same route with the plain
    versions; and the launches of each kernel per block."""
    cfg = tclip.CLIPConfig(vision=tclip.VisionConfig(image_size=32, patch_size=16, width=64,
                                                     layers=2, heads=1, embed_dim=32),
                           text=tclip.CLIPConfig.tiny().text, embed_dim=32)
    params = tree_to(tclip.init_clip_params(torch.Generator().manual_seed(0), cfg), cuda_device)
    images = torch.randn((4, 32, 32, 3), generator=torch.Generator().manual_seed(1)).to(cuda_device)
    stats = tquant.calibrate_vision_tower(params, images, cfg)
    qv = tquant.quantize_vision_tower_static(params, stats, heads=cfg.vision.heads)
    counters = (tim.ln_quantize_static, tim.row_quant_static, tms.fused_mha_packed_q,
                tms.fused_mha_packed_q3, fused_mha_packed)
    per_block = {"static": (2, 1, 0, 0, 1), "static_qa": (2, 0, 1, 0, 0),
                 "static3d": (0, 0, 0, 0, 1), "static3d_qa": (0, 0, 0, 1, 0),
                 "static3d_qaf": (0, 0, 0, 1, 0)}
    got = {}
    for route in STATIC_ROUTES:
        before = [c.launches for c in counters]
        got[route] = tquant.encode_image_int8(qv, images, cfg, gemm_impl=route).double()
        torch.cuda.synchronize()
        assert [c.launches - n for c, n in zip(counters, before)] == [
            cfg.vision.layers * k for k in per_block[route]], route
    plain_int8_kernels(monkeypatch)
    for route in STATIC_ROUTES:
        want = tquant.encode_image_int8(qv, images, cfg, gemm_impl=route).double()
        cos = torch.nn.functional.cosine_similarity(got[route], want, dim=-1).min().item()
        err = (got[route] - want).abs().max().item()
        rms = want.pow(2).mean().sqrt().item()
        assert cos >= 0.9999 and err <= 5e-3 * rms + 1e-6, (route, cos, err, rms)


# -- the static tower's epilogues and layer norm -> int8 --------------------

def plain_epilogues(monkeypatch):
    """Send the static tower's epilogues and layer norm to their plain versions."""
    for name in ("static_requant", "static_residual", "ln_quant_folded"):
        monkeypatch.setattr(tquant, name, getattr(tim, name + "_reference"))


def epilogue_inputs(lead, n, device, seed=0):
    """int32 sums of a K=768 product, a site's vectors in a calibrated
    tower's ranges (dequantized values of a few units, inv_a putting them at
    tens of int8 steps) and a bf16 residual."""
    g = torch.Generator(device=device).manual_seed(seed)
    acc = torch.randint(-400_000, 400_000, (*lead, n), generator=g, device=device,
                        dtype=torch.int32)
    scale = torch.rand((1, n), generator=g, device=device) * 2e-5 + 1e-6
    bias = torch.randn(n, generator=g, device=device) * 0.1
    inv_a = torch.rand((1, n), generator=g, device=device) * 40 + 10
    x = torch.randn((*lead, n), generator=g, device=device).to(torch.bfloat16)
    return acc, scale, bias, inv_a, x


def assert_rarely_one_int8_step(got, want, share: float = 1e-3) -> float:
    """At most one int8 step, on under ``share`` of the outputs; returns the share."""
    assert got.dtype == want.dtype == torch.int8 and got.shape == want.shape
    diff = (got.int() - want.int()).abs()
    assert diff.max().item() <= 1, diff.max().item()
    moved = (diff > 0).float().mean().item()
    assert moved < share, moved
    return moved


# (leading dims, N): the vision tower's qkv, fc and out/proj sites at B=128,
# the CLS rows of the last block, the gate batch's qkv rows plus five (no
# multiple of any tile), the text tower's sites at four prompts
EPILOGUE_SHAPES = [
    pytest.param((128 * 197,), 2304, id="vision-qkv"),
    pytest.param((128 * 197,), 3072, id="vision-fc"),
    pytest.param((128 * 197,), 768, id="vision-out"),
    pytest.param((128, 1), 768, id="cls-rows"),
    pytest.param((16 * 197 + 5,), 2304, id="ragged-qkv"),
    pytest.param((4, 77), 512, id="text-out"),
    pytest.param((4, 77), 1536, id="text-qkv"),
    pytest.param((4, 77), 2048, id="text-fc"),
]


@pytest.mark.parametrize("lead,n", EPILOGUE_SHAPES)
@pytest.mark.parametrize("gelu", [None, "tanh", "sigmoid"])
def test_static_requant_kernel_matches_the_composition(cuda_device, lead, n, gelu):
    """Bit for bit without an activation; with one (PyTorch's GELU formulas,
    contracted by another build) at most one int8 step on under 0.1 %."""
    acc, scale, bias, inv_a, _ = epilogue_inputs(lead, n, cuda_device)
    launches = tim.static_requant.launches
    got = tim.static_requant(acc, scale, bias, inv_a, activation=gelu)
    torch.cuda.synchronize()
    assert tim.static_requant.launches == launches + 1
    want = tim.static_requant_reference(acc, scale, bias, inv_a, gelu)
    if gelu is None:
        assert torch.equal(got, want)
    else:
        print(f"static_requant {gelu} {lead}x{n}: {assert_rarely_one_int8_step(got, want):.2e} "
              "of the outputs one step off")


@pytest.mark.parametrize("lead,n", EPILOGUE_SHAPES)
@pytest.mark.parametrize("with_residual", [True, False], ids=["residual", "bf16-out"])
def test_static_residual_kernel_is_the_composition_bit_for_bit(cuda_device, lead, n,
                                                               with_residual):
    acc, scale, bias, _, x = epilogue_inputs(lead, n, cuda_device, seed=1)
    launches = tim.static_residual.launches
    got = tim.static_residual(acc, scale, bias, x if with_residual else None)
    torch.cuda.synchronize()
    assert tim.static_residual.launches == launches + 1
    want = tim.static_residual_reference(acc, scale, bias, x if with_residual else None)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_static_epilogues_take_the_cls_view_and_a_sliced_kqs_site(cuda_device):
    """The CLS form's residual ``x[:, :1]`` (rows S·D apart) and the ``kqs``
    split GEMM's k/v site, whose vectors are slices of the qkv site's."""
    b, s, d = 128, 197, 768
    acc, scale, bias, inv_a, _ = epilogue_inputs((b, s), 3 * d, cuda_device, seed=2)
    x = torch.randn((b, s, d), device=cuda_device).to(torch.bfloat16)
    out_acc = acc[:, :1, :d].contiguous()
    got = tim.static_residual(out_acc, scale[..., :d], bias[:d], x[:, :1])
    assert torch.equal(got, tim.static_residual_reference(out_acc, scale[..., :d], bias[:d],
                                                          x[:, :1]))
    kv = acc[..., d:].contiguous()
    got = tim.static_requant(kv, scale[..., d:], bias[d:], inv_a[..., d:])
    assert torch.equal(got, tim.static_requant_reference(kv, scale[..., d:], bias[d:],
                                                         inv_a[..., d:]))
    q = acc[:, :1, :d].contiguous()
    got = tim.static_requant(q, scale[..., :d], bias[:d], inv_a[..., :d])
    assert torch.equal(got, tim.static_requant_reference(q, scale[..., :d], bias[:d],
                                                         inv_a[..., :d]))


@pytest.mark.parametrize("lead,d", [pytest.param((128, 197), 768, id="vision"),
                                    pytest.param((128, 1), 768, id="cls-rows"),
                                    pytest.param((16 * 197 + 5,), 768, id="ragged"),
                                    pytest.param((4, 77), 512, id="text"),
                                    pytest.param((37,), 1024, id="widest-ragged")])
@pytest.mark.parametrize("two_pass", [False, True], ids=["1pass", "2pass"])
def test_ln_quant_static3_kernel_matches_the_composition(cuda_device, lead, d, two_pass):
    """At most one int8 step on under 0.1 % (the sums in another order)."""
    x, gamma, beta, inv_a = producer_inputs(math.prod(lead), d, cuda_device)
    x = x.reshape(*lead, d)
    launches = tim.ln_quant_folded.launches
    got = tim.ln_quant_folded(x, gamma, beta, inv_a, two_pass=two_pass)
    torch.cuda.synchronize()
    assert tim.ln_quant_folded.launches == launches + 1
    want = tim.ln_quant_folded_reference(x, gamma, beta, inv_a, two_pass)
    print(f"ln_quant_folded {'2pass' if two_pass else '1pass'} {lead}x{d}: "
          f"{assert_rarely_one_int8_step(got, want):.2e} of the outputs one step off")


def test_static_epilogue_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    acc, scale, bias, inv_a, x = epilogue_inputs((8,), 64, cuda_device)
    with pytest.raises(TypeError, match="int32"):
        tim.static_requant(acc.float(), scale, bias, inv_a)
    with pytest.raises(ValueError, match="divisible by 8"):
        tim.static_residual(acc[:, :60].contiguous(), scale[:, :60], bias[:60])
    with pytest.raises(TypeError, match="bfloat16"):
        tim.static_residual(acc, scale, bias, x.float())
    with pytest.raises(ValueError, match="lies on"):
        tim.static_requant(acc, scale.cpu(), bias, inv_a)
    with pytest.raises(TypeError, match="bfloat16"):
        tim.ln_quant_folded(x.float(), scale, bias, inv_a)
    xw, gamma, beta, inv_w = producer_inputs(8, 2048, cuda_device)
    with pytest.raises(ValueError, match="wider"):
        tim.ln_quant_folded(xw, gamma, beta, inv_w)
    site = {"w_q": torch.ones((64, 64), dtype=torch.int8, device=cuda_device), "scale": scale,
            "b": bias}
    with pytest.raises(ValueError, match="requantized"):
        tquant._static_linear3(acc.to(torch.int8), site, activation="gelu_tanh")


@pytest.mark.parametrize("cls_last,per_encode", [
    pytest.param("kq", lambda n: (2 * n, 2 * n, 2 * n), id="kq"),
    pytest.param("kqs", lambda n: (2 * n + 1, 2 * n, 2 * n), id="kqs"),
    pytest.param("0", lambda n: (2 * n, 2 * n, 2 * n), id="full")])
def test_static3d_qi_encode_launches_each_epilogue_per_gemm(cuda_device, monkeypatch, cls_last,
                                                            per_encode):
    """A 12-layer tower (head width 64) on static3d_qi: each block runs two
    layer norms to int8, two requantize epilogues (qkv, fc; ``kqs`` splits the
    last qkv in two) and two residual epilogues (out, proj), 24 of each in
    an encode; and the tower's features match the same tower with the plain
    epilogues."""
    cfg = tclip.CLIPConfig(vision=tclip.VisionConfig(image_size=32, patch_size=16, width=64,
                                                     layers=12, heads=1, embed_dim=32),
                           text=tclip.CLIPConfig.tiny().text, embed_dim=32)
    params = tree_to(tclip.init_clip_params(torch.Generator().manual_seed(0), cfg), cuda_device)
    images = torch.randn((32, 32, 32, 3), generator=torch.Generator().manual_seed(1)).to(cuda_device)
    qv = tquant.quantize_vision_tower_static(params, tquant.calibrate_vision_tower(
        params, images, cfg), heads=cfg.vision.heads)
    counters = (tim.static_requant, tim.ln_quant_folded, tim.static_residual)
    before = [c.launches for c in counters]
    got = tquant.encode_image_int8(qv, images, cfg, cls_last=cls_last).double()
    torch.cuda.synchronize()
    assert tuple(c.launches - n for c, n in zip(counters, before)) == per_encode(12)
    plain_epilogues(monkeypatch)
    want = tquant.encode_image_int8(qv, images, cfg, cls_last=cls_last).double()
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).min().item()
    err = (got - want).abs().max().item()
    rms = want.pow(2).mean().sqrt().item()
    assert cos >= 0.9999 and err <= 5e-3 * rms + 1e-6, (cos, err, rms)


# -- the pre-split attention, and the fused out-projection and attention sub-block --

@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,h,s,dh,kv_len", [
    (128, 12, 197, 64, None), (128, 12, 197, 64, 147), (4, 12, 197, 64, 150), (3, 4, 37, 32, 20),
    (2, 2, 130, 128, None)])
def test_mha_short_kernel_matches_plain_version(cuda_device, dtype, atol, b, h, s, dh, kv_len):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((b, h, s, dh), generator=g, device=cuda_device).to(dtype)
               for _ in range(3))
    launches = tms.fused_mha_short.launches
    out = tms.fused_mha_short(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert tms.fused_mha_short.launches == launches + 1
    assert out.dtype == dtype and out.shape == (b, h, s, dh)
    torch.testing.assert_close(out.float(), tms.mha_short_reference(q, k, v, kv_len).float(),
                               rtol=0, atol=atol)


def test_mha_short_kernel_takes_head_split_views(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    b, s, h, dh = 4, 197, 12, 64
    qkv = torch.randn((b, s, 3 * h * dh), generator=g, device=cuda_device)
    q, k, v = (t.reshape(b, s, h, dh).permute(0, 2, 1, 3) for t in qkv.split(h * dh, dim=-1))
    torch.testing.assert_close(tms.fused_mha_short(q, k, v, 150),
                               tms.mha_short_reference(q, k, v, 150), rtol=0, atol=1e-5)
    # and the packed kernel on the same rows, which is the same kernel on other strides
    torch.testing.assert_close(tms.fused_mha_short(q, k, v).permute(0, 2, 1, 3).reshape(b, s, -1),
                               fused_mha_packed(qkv, h), rtol=0, atol=0)


def fused_block_inputs(b, s, h, dh, dtype, device, seed=0):
    """x, a layer norm's affine, and the attention's weights and biases, the
    biases and affine non-zero; the packed qkv for the out-projection kernel."""
    g = torch.Generator(device=device).manual_seed(seed)
    d = h * dh

    def randn(*shape, std=1.0, mean=0.0):
        return torch.randn(shape, generator=g, device=device) * std + mean

    x = randn(b, s, d).to(dtype)
    ln = (randn(d, std=0.3, mean=1.0), randn(d, std=0.2))
    attn = (randn(d, 3 * d, std=d ** -0.5).to(dtype), randn(3 * d, std=0.5),
            randn(d, d, std=d ** -0.5).to(dtype), randn(d, std=0.5))
    return x, ln, attn, randn(b, s, 3 * d).to(dtype)


FUSED_SHAPES = [(128, 197, 12, 64, False), (32, 77, 8, 64, True), (3, 37, 4, 32, False),
                (2, 21, 2, 64, True)]


def assert_fused_close(out, ref, dtype):
    assert out.dtype == ref.dtype == dtype and out.shape == ref.shape
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7, atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,dh,causal", FUSED_SHAPES)
def test_mha_packed_proj_kernel_matches_plain_version(cuda_device, dtype, b, s, h, dh, causal):
    x, _, (_, _, out_w, out_b), qkv = fused_block_inputs(b, s, h, dh, dtype, cuda_device)
    before = (tms.fused_mha_packed_proj.launches, tms.fused_mha_packed_proj.causal_launches)
    out = tms.fused_mha_packed_proj(qkv, out_w, out_b, x, h, causal=causal)
    torch.cuda.synchronize()
    assert (tms.fused_mha_packed_proj.launches, tms.fused_mha_packed_proj.causal_launches) == (
        before[0] + 1, before[1] + int(causal))
    assert_fused_close(out, tms.mha_packed_proj_reference(qkv, out_w, out_b, x, h, causal), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,dh,causal", FUSED_SHAPES)
def test_attn_block_kernels_match_plain_version(cuda_device, dtype, b, s, h, dh, causal):
    x, ln, attn, _ = fused_block_inputs(b, s, h, dh, dtype, cuda_device, seed=1)
    counts = lambda: (tms.fused_attn_block.launches, tms.fused_attn_block.causal_launches,  # noqa: E731
                      tms.fused_attn_block.proj_launches, tms.fused_mha_packed_proj.launches)
    before = counts()
    out = tms.fused_attn_block(x, *ln, *attn, h, causal=causal)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + int(causal), before[2] + 1, before[3])
    assert_fused_close(out, tms.attn_block_reference(x, *ln, *attn, h, causal), dtype)


@pytest.mark.parametrize("impl", ["attn_block", "mha_packed_proj"])
def test_towers_through_the_fused_kernels_match_plain_attention(cuda_device, impl):
    cfg = tclip.CLIPConfig.tiny()  # head width 32
    params = tclip.init_clip_params(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(3)
    for blk in params["vision"]["blocks"] + params["text"]["blocks"]:
        for key in ("qkv_b", "out_b"):
            blk["attn"][key] = torch.randn(blk["attn"][key].shape, generator=g) * 0.5
    params = tclip.cast_frozen_params(params, torch.float32, cuda_device, impl)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    images = torch.randn((4, 32, 32, 3), generator=g, device=cuda_device)
    tokens = torch.randint(1, 1000, (4, 77), generator=g, device=cuda_device)
    counter = tms.fused_attn_block if impl == "attn_block" else tms.fused_mha_packed_proj
    launches, causal = counter.launches, counter.causal_launches
    img = tclip.encode_image(params, images, cfg, attn_impl=impl)
    txt = tclip.encode_text(params, tokens, cfg, attn_impl=impl)
    assert (counter.launches - launches, counter.causal_launches - causal) == (
        cfg.vision.layers + cfg.text.layers, cfg.text.layers)
    torch.testing.assert_close(img, tclip.encode_image(params, images, cfg, attn_impl="xla"),
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(txt, tclip.encode_text(params, tokens, cfg, attn_impl="xla"),
                               rtol=1e-4, atol=1e-5)


# the bf16 tensor-core kernels at their edges: key and query tiles whole and
# ragged by one (S = 16, 17, 64, 65), one row, one sample, the text tower's
# causal S=77 at H=8, head width 32 at D=768 and at D=160 (no multiple of the
# 64-deep weight slices), and past the 256 keys whose logits a thread keeps
# in registers (the three-pass windows)
BF16_EDGE_SHAPES = [(2, 16, 4, 64, False), (2, 17, 4, 64, True), (2, 64, 4, 64, True),
                    (2, 65, 4, 64, False), (3, 65, 2, 64, True), (1, 1, 4, 64, False),
                    (1, 1, 2, 64, True), (1, 40, 4, 32, False), (3, 77, 8, 64, True),
                    (2, 37, 24, 32, False), (2, 33, 5, 32, True), (2, 300, 4, 64, True),
                    (2, 300, 4, 32, False)]


def _both_fused(inputs, h, causal):
    """(kernel, plain version) of the out-projection and the whole sub-block."""
    x, ln, attn, qkv = inputs
    return [(tms.fused_mha_packed_proj(qkv, attn[2], attn[3], x, h, causal=causal),
             tms.mha_packed_proj_reference(qkv, attn[2], attn[3], x, h, causal)),
            (tms.fused_attn_block(x, *ln, *attn, h, causal=causal),
             tms.attn_block_reference(x, *ln, *attn, h, causal))]


@pytest.mark.parametrize("b,s,h,dh,causal", BF16_EDGE_SHAPES)
def test_bf16_fused_kernels_at_the_tile_edges(cuda_device, b, s, h, dh, causal):
    inputs = fused_block_inputs(b, s, h, dh, torch.bfloat16, cuda_device, seed=2)
    for out, ref in _both_fused(inputs, h, causal):
        torch.cuda.synchronize()
        assert_fused_close(out, ref, torch.bfloat16)


def _cuda_core_bf16_smem(s, d, dh):
    """Shared memory of the CUDA-core bf16 kernel that the tensor-core one
    replaced (64-row o tile, padded K/V, per-warp row buffers)."""
    a16 = lambda n: (n + 15) // 16 * 16  # noqa: E731
    return a16(64 * (d + 2) * 2) + max(a16(2 * s * (dh + 2) * 2), 32 * 128 * 2) + 8 * (s + dh) * 4


def test_bf16_fused_kernels_take_every_shape_the_cuda_core_kernel_took(cuda_device):
    lib = tms._block_library()
    fits = lambda s, d, dh: lib.team_attn_block_smem_bytes(0, 1, s, d, dh) <= tms._SMEM_LIMIT  # noqa: E731
    for dh in (32, 64):
        for h in range(1, 1 + 1800 // dh):
            d = h * dh
            for s in range(1, 1400):
                if _cuda_core_bf16_smem(s, d, dh) > tms._SMEM_LIMIT:
                    break
                assert fits(s, d, dh), (s, d, dh)


def test_bf16_fused_kernels_at_the_longest_s_and_one_past(cuda_device):
    lib = tms._block_library()
    h, dh = 12, 64
    longest = max(s for s in range(1, 2048)
                  if lib.team_attn_block_smem_bytes(0, 1, s, h * dh, dh) <= tms._SMEM_LIMIT)
    assert longest >= 445  # the CUDA-core kernel's longest at this width
    for causal in (False, True):
        inputs = fused_block_inputs(1, longest, h, dh, torch.bfloat16, cuda_device, seed=4)
        for out, ref in _both_fused(inputs, h, causal):
            torch.cuda.synchronize()
            assert_fused_close(out, ref, torch.bfloat16)
    x, ln, attn, qkv = fused_block_inputs(1, longest + 1, h, dh, torch.bfloat16, cuda_device)
    launches = (tms.fused_attn_block.launches, tms.fused_mha_packed_proj.launches)
    with pytest.raises(ValueError, match="shared memory"):
        tms.fused_mha_packed_proj(qkv, attn[2], attn[3], x, h)
    with pytest.raises(ValueError, match="shared memory"):
        tms.fused_attn_block(x, *ln, *attn, h)
    assert (tms.fused_attn_block.launches, tms.fused_mha_packed_proj.launches) == launches


def test_bf16_fused_kernels_cast_f32_weights_and_take_unaligned_inputs(cuda_device):
    b, s, h, dh = 2, 65, 4, 64
    x, ln, attn, qkv = fused_block_inputs(b, s, h, dh, torch.bfloat16, cuda_device, seed=5)
    g = torch.Generator(device=cuda_device).manual_seed(6)
    d = h * dh
    w_qkv, w_out = (torch.randn(shape, generator=g, device=cuda_device) * d ** -0.5
                    for shape in ((d, 3 * d), (d, d)))  # float32, cast by the wrappers
    attn = (w_qkv, attn[1], w_out, attn[3])

    def unaligned(t):  # the same values, 2 bytes past a 16-byte boundary
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    counts = lambda: (tms.fused_mha_packed_proj.launches, tms.fused_attn_block.launches,  # noqa: E731
                      tms.fused_attn_block.proj_launches)
    for xs, qkvs in ((x, qkv), (unaligned(x), unaligned(qkv))):
        before = counts()
        pairs = _both_fused((xs, ln, attn, qkvs), h, False)
        torch.cuda.synchronize()
        assert counts() == (before[0] + 1, before[1] + 1, before[2] + 1)
        for out, ref in pairs:
            assert_fused_close(out, ref, torch.bfloat16)


def test_fused_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    x, ln, attn, qkv = fused_block_inputs(2, 8, 4, 16, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="head width"):
        tms.fused_attn_block(x, *ln, *attn, 4)
    with pytest.raises(ValueError, match="head width"):
        tms.fused_mha_packed_proj(qkv, attn[2], attn[3], x, 4)
    x, ln, attn, qkv = fused_block_inputs(2, 8, 1, 64, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        tms.fused_mha_packed_proj(qkv.transpose(0, 1).contiguous().transpose(0, 1), attn[2],
                                  attn[3], x, 1)
    with pytest.raises(ValueError, match="lies on"):
        tms.fused_attn_block(x, ln[0].cpu(), ln[1], *attn, 1)
    with pytest.raises(ValueError, match="shared memory"):
        tms.fused_mha_packed_proj(torch.zeros((1, 2048, 3 * 64), device=cuda_device),
                                  attn[2], attn[3], torch.zeros((1, 2048, 64), device=cuda_device), 1)
    with pytest.raises(ValueError, match="head width"):
        tms.fused_mha_short(*(torch.zeros((1, 2, 8, 48), device=cuda_device) for _ in range(3)))


# -- the integer-QKᵀ kernel's other modes and entries, and the routes that use them --

# (TEAM_QI_SOFTMAX, TEAM_QI_ROWSUM, pv_int8, defer_norm, b, s, h, dh, causal, kv_len)
Q3I_MODES = [
    ("exp2i", "mxu", False, False, 128, 197, 12, 64, False, None),
    ("exp2i", "mxu", False, False, 4, 77, 8, 64, True, None),  # masked: the f32 form
    ("f32", "reduce", False, False, 128, 197, 12, 64, False, None),
    ("static", "reduce", False, True, 128, 197, 12, 64, False, None),
    ("exp2i", "reduce", False, True, 4, 197, 12, 64, False, 150),
    ("exp2i", "reduce", False, True, 3, 37, 4, 32, False, None),
    ("static", "mxu", True, False, 128, 197, 12, 64, False, None),
    ("f32", "mxu", True, True, 3, 37, 4, 64, False, None),
    ("exp2i", "reduce", True, True, 4, 77, 8, 64, True, 60),
    # each mode besides the default at the text tower's causal shape and at
    # kv_len < S, where exp2i and the static form fall to the f32 row max
    *((softmax, rowsum, pv_int8, defer, *shape)
      for softmax, rowsum, pv_int8, defer in (
          ("exp2i", "mxu", False, False), ("static", "reduce", False, False),
          ("static", "reduce", False, True), ("static", "mxu", True, False),
          ("static", "mxu", True, True))
      for shape in ((32, 77, 8, 64, True, None), (32, 197, 12, 64, False, 150))),
    ("static", "reduce", False, False, 128, 197, 12, 64, False, None),
    ("static", "mxu", True, True, 128, 197, 12, 64, False, None),
]


@pytest.mark.parametrize("softmax,rowsum,pv_int8,defer,b,s,h,dh,causal,kv_len", Q3I_MODES)
def test_q3i_kernel_modes_match_plain_version(cuda_device, monkeypatch, softmax, rowsum, pv_int8,
                                              defer, b, s, h, dh, causal, kv_len):
    monkeypatch.setenv("TEAM_QI_SOFTMAX", softmax)
    monkeypatch.setenv("TEAM_QI_ROWSUM", rowsum)
    qkv, deq, qks, oinv, m2 = q3i_inputs(b, s, h, cuda_device, seed=2, dh=dh)
    kw = dict(causal=causal, kv_len=kv_len, qk_m2=m2, pv_int8=pv_int8, defer_norm=defer)
    launches = fused_mha_packed_q3i.launches
    out = fused_mha_packed_q3i(qkv, deq, qks, oinv, h, **kw)
    torch.cuda.synchronize()
    assert fused_mha_packed_q3i.launches == launches + 1
    assert_within_one_int8_step(out, tms.mha_packed_q3i_plain(qkv, deq, qks, oinv, h, **kw),
                                pv_int8_limit(deq, oinv) if pv_int8 else 1)


@pytest.mark.parametrize("b,s,h,dh", [(128, 197, 12, 64), (3, 37, 4, 32)])
@pytest.mark.parametrize("static", [True, False])
@pytest.mark.parametrize("softmax", ["static", "exp2i"])
def test_q3i_cls_split_kernel_equals_the_cls_kernel(cuda_device, monkeypatch, b, s, h, dh, static,
                                                    softmax):
    """The split entry reads q, k and v through other strides and must give
    what the CLS entry gives on the packed tensor they make, bit for bit."""
    monkeypatch.setenv("TEAM_QI_SOFTMAX", softmax)
    qkv, deq, qks, oinv, m2 = q3i_inputs(b, s, h, cuda_device, seed=3, dh=dh)
    m2 = m2 if static else None
    d = h * dh
    q, kv = qkv[:, :1, :d].contiguous(), qkv[:, :, d:].contiguous()
    before = (fused_mha_packed_q3i_cls.launches, tms.fused_mha_packed_q3i_cls_split.launches)
    out = tms.fused_mha_packed_q3i_cls_split(q, kv, deq, qks, oinv, h, qk_m2=m2)
    packed = fused_mha_packed_q3i_cls(qkv, deq, qks, oinv, h, qk_m2=m2)
    torch.cuda.synchronize()
    assert (fused_mha_packed_q3i_cls.launches, tms.fused_mha_packed_q3i_cls_split.launches) == (
        before[0] + 1, before[1] + 1)
    assert out.shape == (b, 1, d) and torch.equal(out, packed)
    assert_within_one_int8_step(out, tms.mha_packed_q3i_cls_split_plain(q, kv, deq, qks, oinv, h,
                                                                        qk_m2=m2))


@pytest.mark.parametrize("s,b,h,dh", [(197, 128, 12, 64), (37, 3, 4, 32), (77, 5, 8, 64)])
def test_q3i_sb_kernel_matches_plain_version_and_the_packed_entry(cuda_device, monkeypatch, s, b,
                                                                  h, dh):
    """Sequence-major [S, B, 3D]: within one step of its plain version, and
    bit for bit what the packed entry gives on the transposed rows with the
    same arithmetic (f32 row max, reduce)."""
    qkv, deq, qks, oinv, _ = q3i_inputs(s, b, h, cuda_device, seed=4, dh=dh)
    launches = tms.fused_mha_packed_q3i_sb.launches
    out = tms.fused_mha_packed_q3i_sb(qkv, deq, qks, oinv, h)
    torch.cuda.synchronize()
    assert tms.fused_mha_packed_q3i_sb.launches == launches + 1
    assert out.shape == (s, b, h * dh) and out.is_contiguous()
    assert_within_one_int8_step(out, tms.mha_packed_q3i_sb_reference(qkv, deq, qks, oinv, h))
    monkeypatch.setenv("TEAM_QI_SOFTMAX", "f32")
    monkeypatch.setenv("TEAM_QI_ROWSUM", "reduce")
    packed = fused_mha_packed_q3i(qkv.transpose(0, 1).contiguous(), deq, qks, oinv, h)
    assert torch.equal(out, packed.transpose(0, 1))


def test_new_q3i_wrappers_reject_what_the_kernel_does_not_take(cuda_device):
    qkv, deq, qks, oinv, m2 = q3i_inputs(2, 8, 4, cuda_device, dh=16)
    with pytest.raises(ValueError, match="head width"):
        tms.fused_mha_packed_q3i_sb(qkv, deq, qks, oinv, 4)
    qkv, deq, qks, oinv, m2 = q3i_inputs(2, 8, 2, cuda_device)
    q, kv = qkv[:, :1, :128], qkv[:, :, 128:]
    with pytest.raises(ValueError, match="contiguous"):
        tms.fused_mha_packed_q3i_cls_split(q, kv.contiguous(), deq, qks, oinv, 2)
    with pytest.raises(ValueError, match="lies on"):
        tms.fused_mha_packed_q3i_cls_split(q.contiguous(), kv.contiguous(), deq, qks.cpu(), oinv, 2)


# -- the int8 attention on the tensor cores: #7's q3i_kernel_tc (#10, #11, #29
#  too) and #5/#6's mha_q_kernel_tc at their tile edges --

# (S, causal, kv_len): S not a multiple of 16 and past one 16-row tile per
# warp (257), one key, causal with and without kv_len, kv_len < S
INT8_EDGES = [(s, causal, kv) for s in (37, 77, 197, 257)
              for causal, kv in ((False, None), (False, 1), (True, None), (True, s // 2),
                                 (False, s - 7))]
# (TEAM_QI_SOFTMAX, TEAM_QI_ROWSUM, pv_int8, defer_norm): every normalisation
# under each softmax the masks leave it
Q3I_EDGE_MODES = [("static", "mxu", False, False), ("exp2i", "mxu", False, False),
                  ("f32", "reduce", False, False), ("static", "reduce", False, True),
                  ("static", "mxu", True, False), ("f32", "mxu", True, True)]


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("s,causal,kv_len", INT8_EDGES)
def test_q3i_tensor_core_kernel_at_the_tile_edges(cuda_device, monkeypatch, s, causal, kv_len, dh):
    qkv, deq, qks, oinv, m2 = q3i_inputs(2, s, 3, cuda_device, seed=s + dh, dh=dh)
    for softmax, rowsum, pv_int8, defer in Q3I_EDGE_MODES:
        monkeypatch.setenv("TEAM_QI_SOFTMAX", softmax)
        monkeypatch.setenv("TEAM_QI_ROWSUM", rowsum)
        kw = dict(causal=causal, kv_len=kv_len, qk_m2=m2, pv_int8=pv_int8, defer_norm=defer)
        out = fused_mha_packed_q3i(qkv, deq, qks, oinv, 3, **kw)
        torch.cuda.synchronize()
        assert_within_one_int8_step(out, tms.mha_packed_q3i_plain(qkv, deq, qks, oinv, 3, **kw),
                                    pv_int8_limit(deq, oinv) if pv_int8 else 1)


@pytest.mark.parametrize("form", ["q", "q3"])
@pytest.mark.parametrize("s,causal,kv_len", INT8_EDGES)
def test_packed_q_tensor_core_kernel_at_the_tile_edges(cuda_device, form, s, causal, kv_len):
    qkv, deq, oinv = packed_q_inputs(2, s, 3, cuda_device, seed=s)
    want = tms.mha_packed_q_reference(qkv, deq, oinv, 3, causal, kv_len, bf16_deq=form == "q3")
    if form == "q":
        out = tms.fused_mha_packed_q(qkv.reshape(2 * s, -1), deq, oinv, 3, seq=s, causal=causal,
                                     kv_len=kv_len).reshape(2, s, -1)
    else:
        out = tms.fused_mha_packed_q3(qkv, deq, oinv, 3, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert_within_one_int8_step(out, want)


def exact_sum_inputs(b, s, heads, dh, device, seed=0):
    """int8 qkv and scales with which the softmax's sums are exact in any
    order: q and k are 0 or +-32 on two dims of each head (0 elsewhere), so
    acc is a multiple of 1024 within +-2048; qk_scale makes qks * log2e
    exactly 2^-10 and qk_m2 is 3, so each static exponential is a power of
    two in [2^-5, 2^-1] and every row sum, and every sum of p * v8 with p such
    a power, holds in f32 whatever the order."""
    import numpy as np

    log2e = np.float32(1.4426950408889634)
    target = np.float32(2.0 ** -10)
    qks = np.float32(target / log2e)
    while np.float32(qks * log2e) != target:
        up = np.float32(qks * log2e) < target
        qks = np.nextafter(qks, np.float32(1) if up else np.float32(0))
    g = torch.Generator(device=device).manual_seed(seed)
    d = heads * dh
    qkv = torch.randint(-127, 128, (b, s, 3 * d), generator=g, device=device, dtype=torch.int8)
    for part in range(2):  # q, then k
        x = torch.zeros((b, s, heads, dh), dtype=torch.int8, device=device)
        x[..., :2] = (torch.randint(-1, 2, (b, s, heads, 2), generator=g, device=device) * 32).to(
            torch.int8)
        qkv[..., part * d:(part + 1) * d] = x.reshape(b, s, d)
    deq = torch.rand((1, 3 * d), generator=g, device=device) * 0.02 + 0.01
    oinv = torch.rand((1, d), generator=g, device=device) * 40 + 20
    return (qkv, deq, torch.full((1, heads), float(qks), device=device), oinv,
            torch.full((1, heads), 3.0, device=device))


@pytest.mark.parametrize("dh,s", [(64, 197), (32, 257), (128, 77)])
def test_q3i_tensor_core_kernel_is_exact_where_its_sums_are(cuda_device, dh, s):
    """Where every sum of the static softmax is exact in any order, the
    default route (p = bf16(e), the ones-column row sum) and the int8 PV with
    and without the deferred divide (p8 = rint(p * 127); its tensor-core sum
    of p8 * v8 is the int32 sum) equal the plain version bit for bit."""
    qkv, deq, qks, oinv, m2 = exact_sum_inputs(4, s, 3, dh, cuda_device, seed=dh + s)
    for kw in ({}, {"pv_int8": True}, {"pv_int8": True, "defer_norm": True}):
        out = fused_mha_packed_q3i(qkv, deq, qks, oinv, 3, qk_m2=m2, **kw)
        torch.cuda.synchronize()
        want = tms.mha_packed_q3i_plain(qkv, deq, qks, oinv, 3, qk_m2=m2, **kw)
        assert torch.equal(out, want), kw


# the longest S the q3i entries take at each head width: the tensor-core
# kernel's 3 * pad16(S) * dh bytes and the CLS kernel's int8 K/V, f32 p and
# 8 warps' p.v sums (csrc/mha_packed_q3i.cu) within 232448 bytes
Q3I_LONGEST_S = {32: (2416, 3402), 64: (1200, 1744), 128: (592, 878)}


# the CLS kernel (#8, #9, q3i_cls_kernel) at its edges: S within one pass of
# q.k (256 keys, a thread each), on its boundary and past it, and across the
# p.v slices; B·H one block, and 793: one more than 6 resident blocks on each
# of 132 SMs, so the last wave holds one block
CLS_EDGE_S = [1, 7, 31, 255, 256, 257, 513]


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("s", CLS_EDGE_S)
def test_q3i_cls_kernel_at_its_edges(cuda_device, monkeypatch, s, dh):
    """Both softmaxes: within one int8 step of the plain version (under 1 %
    of the outputs of both shapes differing), and the split entry bit for
    bit the packed one."""
    for softmax in ("static", "f32"):
        monkeypatch.setenv("TEAM_QI_SOFTMAX", softmax)
        got, want = [], []
        for b, h in ((1, 1), (61, 13)):
            qkv, deq, qks, oinv, m2 = q3i_inputs(b, s, h, cuda_device, seed=s + dh + h, dh=dh)
            d = h * dh
            launches = (tms.fused_mha_packed_q3i_cls.launches,
                        tms.fused_mha_packed_q3i_cls_split.launches)
            out = tms.fused_mha_packed_q3i_cls(qkv, deq, qks, oinv, h, qk_m2=m2)
            split = tms.fused_mha_packed_q3i_cls_split(qkv[:, :1, :d].contiguous(),
                                                       qkv[:, :, d:].contiguous(), deq, qks, oinv,
                                                       h, qk_m2=m2)
            torch.cuda.synchronize()
            assert (tms.fused_mha_packed_q3i_cls.launches,
                    tms.fused_mha_packed_q3i_cls_split.launches) == (launches[0] + 1,
                                                                     launches[1] + 1)
            assert out.shape == (b, 1, d) and torch.equal(out, split), (softmax, b, h)
            got.append(out.reshape(-1))
            want.append(tms.mha_packed_q3i_cls_plain(qkv, deq, qks, oinv, h, qk_m2=m2).reshape(-1))
        assert_within_one_int8_step(torch.cat(got), torch.cat(want))


@pytest.mark.parametrize("dh,s", [(64, 197), (32, 257), (128, 513)])
def test_q3i_cls_kernel_is_exact_where_its_sums_are(cuda_device, dh, s):
    """On inputs whose static softmax sums are exact in any order
    (exact_sum_inputs), the CLS kernel's own order of l and p·v gives the
    plain version bit for bit."""
    qkv, deq, qks, oinv, m2 = exact_sum_inputs(61, s, 13, dh, cuda_device, seed=dh + s)
    out = tms.fused_mha_packed_q3i_cls(qkv, deq, qks, oinv, 13, qk_m2=m2)
    torch.cuda.synchronize()
    assert torch.equal(out, tms.mha_packed_q3i_cls_plain(qkv, deq, qks, oinv, 13, qk_m2=m2))


@pytest.mark.parametrize("dh", [32, 64, 128])
def test_q3i_entries_take_their_longest_s_and_reject_one_more(cuda_device, dh):
    """Each kernel runs at its longest S (within one int8 step of the plain
    version) and an S one longer raises before anything is launched."""
    tc_s, cls_s = Q3I_LONGEST_S[dh]
    qkv, deq, qks, oinv, m2 = q3i_inputs(1, tc_s, 2, cuda_device, seed=dh, dh=dh)
    out = fused_mha_packed_q3i(qkv, deq, qks, oinv, 2, qk_m2=m2)
    torch.cuda.synchronize()
    assert_within_one_int8_step(out, tms.mha_packed_q3i_plain(qkv, deq, qks, oinv, 2, qk_m2=m2))
    qkv, deq, qks, oinv, m2 = q3i_inputs(16, cls_s, 2, cuda_device, seed=dh, dh=dh)
    out = tms.fused_mha_packed_q3i_cls(qkv, deq, qks, oinv, 2, qk_m2=m2)
    torch.cuda.synchronize()
    assert_within_one_int8_step(out, tms.mha_packed_q3i_cls_plain(qkv, deq, qks, oinv, 2,
                                                                  qk_m2=m2))
    launches = (fused_mha_packed_q3i.launches, tms.fused_mha_packed_q3i_cls.launches)
    for s, call in ((tc_s + 1, fused_mha_packed_q3i), (cls_s + 1, tms.fused_mha_packed_q3i_cls)):
        qkv, deq, qks, oinv, m2 = q3i_inputs(1, s, 2, cuda_device, seed=dh, dh=dh)
        with pytest.raises(ValueError, match="shared memory"):
            call(qkv, deq, qks, oinv, 2, qk_m2=m2)
    assert (fused_mha_packed_q3i.launches, tms.fused_mha_packed_q3i_cls.launches) == launches


def test_q3i_variant_full_is_the_packed_q3i_kernel_at_the_vision_batch(cuda_device):
    from team_tpu_torch.scripts import r4_attn_decomp as r4

    qkv, qks, qkm2, oinv = r4.make_inputs(128, cuda_device)
    ones = torch.ones((1, 3 * r4.D), device=cuda_device)
    assert torch.equal(tms.fused_mha_q3i_variant(qkv, qks, qkm2, oinv, r4.H, "full"),
                       fused_mha_packed_q3i(qkv, ones, qks, oinv, r4.H, qk_m2=qkm2))


def test_int8_attention_kernels_issue_imma_and_hmma(cuda_device):
    """Every instantiation of #7's kernel runs q.k on the s8 tensor cores
    (IMMA), and p.v on the bf16 ones (HMMA) where it has a PV: 3 head widths
    x (5 normalisations x 2 softmaxes + the probe's noexp), and the probe's
    qkonly and nopv (VAR 2 and 3, the last template argument) at 3 head
    widths with IMMA alone; the CLS kernel q3i_cls_kernel (3 head widths)
    neither; #5/#6's
    kernel (2 dequants x 3 logits windows) HMMA."""
    tms.build()
    _assert_issued(sass_tables.IMMA_SOURCES, "mha_packed_q3i.cu", "IMMA")
    imma = {fn: len(found) for fn, found in _opcode_per_kernel("mha_packed_q3i.cu", "IMMA").items()}
    hmma = _hmma_per_kernel("mha_packed_q3i.cu")
    var = {fn: int(m.group(1)) for fn in imma
           if (m := re.search(r"q3i_kernel_tcILi\d+ELi\d+ELb[01]ELi(\d)EE", fn))}
    tc = [fn for fn in var if var[fn] < 2]
    sliced = [fn for fn in var if var[fn] >= 2]
    cls = [fn for fn in imma if "q3i_cls_kernel" in fn]
    assert len(var) == len([fn for fn in imma if "q3i_kernel_tc" in fn]), imma
    assert len(tc) == 33 and min(min(imma[f], hmma[f]) for f in tc) > 0, (imma, hmma)
    assert len(sliced) == 6 and min(imma[f] for f in sliced) > 0, imma
    assert max(hmma[f] for f in sliced) == 0, hmma
    assert len(cls) == 3 and max(imma[f] + hmma[f] for f in cls) == 0, (imma, hmma)
    q = [n for fn, n in _hmma_per_kernel("mha_packed_q.cu").items() if "mha_q_kernel_tc" in fn]
    assert len(q) == 6 and min(q) > 0, q


# (gemm_impl, cls_last, env, launches per encode of an L-layer tower as
#  (q3i, q3i_cls, q3i_cls_split, q3i_sb, packed bf16))
NEW_ROUTES = [
    pytest.param("static3d_qis", None, {}, lambda n: (0, 0, 0, n, 0), id="qis"),
    pytest.param("static3d_qib", None, {"TEAM_FLAT_B": "2"}, lambda n: (n - 1, 1, 0, 0, 0),
                 id="qib"),
    pytest.param("static3d_qi2", None, {}, lambda n: (n, 0, 0, 0, 0), id="qi2"),
    pytest.param("static3d_qi", "kqs", {}, lambda n: (n - 1, 0, 1, 0, 0), id="kqs"),
    pytest.param("static3d_qi", "mlp", {}, lambda n: (n, 0, 0, 0, 0), id="mlp"),
    pytest.param("static3d_qi", "attn", {}, lambda n: (n - 1, 0, 0, 0, 0), id="attn"),
    pytest.param("static3d_qi", None, {"TEAM_QI_SOFTMAX": "exp2i"},
                 lambda n: (n - 1, 1, 0, 0, 0), id="exp2i"),
    pytest.param("static3d_qi", None, {"TEAM_QI_ROWSUM": "reduce", "TEAM_QI_DEFER": "1"},
                 lambda n: (n - 1, 1, 0, 0, 0), id="reduce-defer"),
    pytest.param("xla", None, {}, lambda n: (0, 0, 0, 0, n), id="xla"),
]


@pytest.mark.parametrize("route,cls_last,env,per_encode", NEW_ROUTES)
def test_new_routes_through_the_kernels_match_plain_versions(cuda_device, monkeypatch, route,
                                                             cls_last, env, per_encode):
    """The tiny tower (head width 32) on the card on each route, CLS mode and
    knob of this group through its kernels, against the same route with the
    plain versions (same card, same payload); and each kernel's launches."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = tclip.CLIPConfig.tiny()
    params = tree_to(tclip.init_clip_params(torch.Generator().manual_seed(0), cfg), cuda_device)
    images = torch.randn((8, 32, 32, 3), generator=torch.Generator().manual_seed(1)).to(cuda_device)
    if route == "xla":
        qv = tquant.quantize_vision_tower(params)
    else:
        qv = tquant.quantize_vision_tower_static(params, tquant.calibrate_vision_tower(
            params, images, cfg), heads=cfg.vision.heads)
    counters = (fused_mha_packed_q3i, fused_mha_packed_q3i_cls,
                tms.fused_mha_packed_q3i_cls_split, tms.fused_mha_packed_q3i_sb, fused_mha_packed)
    before = [c.launches for c in counters]
    got = tquant.encode_image_int8(qv, images, cfg, gemm_impl=route, cls_last=cls_last).double()
    torch.cuda.synchronize()
    assert tuple(c.launches - n for c, n in zip(counters, before)) == per_encode(cfg.vision.layers)
    for name, plain in (("fused_mha_packed_q3i_tp", tms.mha_packed_q3i_plain),
                        ("fused_mha_packed_q3i_cls", tms.mha_packed_q3i_cls_plain),
                        ("fused_mha_packed_q3i_cls_split", tms.mha_packed_q3i_cls_split_plain),
                        ("fused_mha_packed_q3i_sb", tms.mha_packed_q3i_sb_reference),
                        ("attention_core", lambda qkv, heads, *, causal, kv_len, impl:
                         mha_packed_reference(qkv, heads, causal, kv_len))):
        monkeypatch.setattr(tquant, name, plain)
    want = tquant.encode_image_int8(qv, images, cfg, gemm_impl=route, cls_last=cls_last).double()
    assert got.shape == (8, cfg.embed_dim) and bool(torch.isfinite(got).all())
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).min().item()
    err = (got - want).abs().max().item()
    rms = want.pow(2).mean().sqrt().item()
    assert cos >= 0.9999 and err <= 5e-3 * rms + 1e-6, (route, cos, err, rms)


# -- the int8 GEMMs and the dynamic layer norm -> int8 of the hybrid and pallas tiers --

def gemm_inputs(m, k, n, device, seed=0):
    """Row-quantized activations, a quantized [K, N] weight (column-major, as
    the payload holds it) and a bias."""
    g = torch.Generator(device=device).manual_seed(seed)
    xq, xs = tim.quantize_rows(torch.randn((m, k), generator=g, device=device))
    wq, ws = tim.quantize_weight(torch.randn((k, n), generator=g, device=device) * k ** -0.5)
    return xq, wq, xs, ws, torch.randn(n, generator=g, device=device) * 0.1


def assert_gemm_close(out, ref):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err = (out.float() - ref.float()).abs()
    limit = 1e-5 * ref.float().abs().max().item()
    if out.dtype == torch.bfloat16:
        limit = limit + 2.0 ** -7 * ref.float().abs()
    assert bool((err <= limit).all()), err.max().item()


RAGGED_M = 16 * 197  # the gate batch's rows: no multiple of a tile


@pytest.mark.parametrize("m,k,n", [
    (128 * 197, 768, 2304), (128 * 197, 768, 768),  # qkv and out at the eval batch
    (RAGGED_M, 768, 2304), (RAGGED_M, 768, 768),
    (RAGGED_M, 512, 1536), (RAGGED_M, 512, 512),    # the text tower's qkv and out
    (37, 64, 96), (1, 768, 768), (37, 96, 264), (37, 32, 8),  # fewer rows than a tile
    (300, 512, 520), (129, 768, 8)])                 # N past a 256-column tile, N 8
@pytest.mark.parametrize("activation", [None, "gelu"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_int8_linear_kernel_matches_plain_version(cuda_device, m, k, n, activation, out_dtype):
    xq, wq, xs, ws, b = gemm_inputs(m, k, n, cuda_device)
    ref = tim.int8_linear_reference(xq, wq, xs, ws, b, activation=activation, out_dtype=out_dtype)
    launches = (tim.int8_linear.launches, tim.int8_linear_nk.launches)
    out = tim.int8_linear(xq, wq, xs, ws, b, activation=activation, out_dtype=out_dtype)
    out_nk = tim.int8_linear_nk(xq, wq.t(), xs, ws, b, activation=activation, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert (tim.int8_linear.launches, tim.int8_linear_nk.launches) == (launches[0] + 1,
                                                                       launches[1] + 1)
    assert_gemm_close(out, ref)
    torch.testing.assert_close(out_nk, out, rtol=0, atol=0)


def test_int8_linear_tilings_and_quantized_linear_are_the_one_kernel(cuda_device):
    xq, wq, xs, ws, b = gemm_inputs(197, 128, 64, cuda_device)
    want = tim.int8_linear(xq, wq, xs, ws, b)
    for fn in (tim.int8_linear_kgrid, tim.int8_linear_wres, tim.int8_linear_dma):
        launches = fn.launches
        torch.testing.assert_close(fn(xq, wq, xs, ws, b), want, rtol=0, atol=0)
        assert fn.launches == launches + 1
    x = torch.randn((33, 128), generator=torch.Generator(device=cuda_device).manual_seed(2),
                    device=cuda_device)
    x_q, x_s = tim.quantize_rows(x)
    torch.testing.assert_close(tim.quantized_linear(x, wq, ws, b), tim.int8_linear(x_q, wq, x_s, ws, b),
                               rtol=0, atol=0)


# (M, K, N, bn, N of the blockscale product that consumes the output): fc
# and proj at the eval batch and the gate batch's rows; bn 256 (the wgmma
# kernel's 128 x 256 tiles) and K not a multiple of the 128-byte TMA box;
# bn 32 and 64, and so bk 32 and 64, on the mma.sync kernels
@pytest.mark.parametrize("m,k,n,block_n,n2", [(128 * 197, 768, 3072, 512, 768),
                                              (RAGGED_M, 768, 3072, 512, 768),
                                              (16 * 197 + 5, 768, 3072, 512, 768),
                                              (37, 768, 3072, 512, 264),
                                              (1000, 768, 1536, 256, 520),
                                              (200, 96, 512, 512, 96), (130, 96, 768, 256, 136),
                                              (40, 64, 128, 32, 96), (300, 256, 512, 64, 136),
                                              (37, 64, 256, 512, 64)])
def test_gelu_quant_and_blockscale_kernels_match_plain_versions(cuda_device, m, k, n, block_n, n2):
    xq, wq, xs, ws, b = gemm_inputs(m, k, n, cuda_device)
    launches = (tim.int8_linear_gelu_quant.launches, tim.int8_linear_blockscale.launches)
    gq, gs = tim.int8_linear_gelu_quant(xq, wq, xs, ws, b, block_n=block_n)
    rq, rs = tim.int8_linear_gelu_quant_reference(xq, wq, xs, ws, b, block_n=block_n)
    torch.cuda.synchronize()
    assert gs.shape == rs.shape == (n // tim._pick_block_n(n, block_n), m)
    assert_within_one_int8_step(gq, rq)
    torch.testing.assert_close(gs, rs, rtol=1e-6, atol=0)
    _, w2q, _, w2s, b2 = gemm_inputs(m, n, n2, cuda_device, seed=1)
    for out_dtype in (torch.bfloat16, torch.float32):
        out = tim.int8_linear_blockscale(gq, w2q, gs, w2s, b2, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert_gemm_close(out, tim.int8_linear_blockscale_reference(gq, w2q, gs, w2s, b2,
                                                                     out_dtype=out_dtype))
    assert (tim.int8_linear_gelu_quant.launches, tim.int8_linear_blockscale.launches) == (
        launches[0] + 1, launches[1] + 2)


@pytest.mark.parametrize("m,k,n,n_kb", [
    (128 * 197, 3072, 768, 6),   # proj at the eval batch, bk 512
    (RAGGED_M, 3072, 768, 6),
    (RAGGED_M, 2048, 512, 4),    # the text tower's proj, bk 512
    (37, 128, 264, 1),           # one block of 128
    (300, 256, 520, 2),          # bk 128, N past a 128-column tile
    (1, 384, 8, 3),
    (129, 1024, 136, 2),
    (200, 480, 96, 3),           # bk 160, no multiple of 128: the mma.sync kernel
    (300, 256, 136, 4)])         # bk 64: the mma.sync kernel
def test_blockscale_kernel_matches_plain_version(cuda_device, m, k, n, n_kb):
    """bf16 and f32 out, on activations with their own scale per row and K
    block: within one bf16 step (2^-7 |ref|) plus 1e-5 of the largest |ref|."""
    g = torch.Generator(device=cuda_device).manual_seed(m + k)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=cuda_device, dtype=torch.int8)
    xs = torch.rand((n_kb, m), generator=g, device=cuda_device) * 0.02 + 1e-3
    _, wq, _, ws, b = gemm_inputs(8, k, n, cuda_device, seed=7)
    for out_dtype in (torch.bfloat16, torch.float32):
        launches = tim.int8_linear_blockscale.launches
        out = tim.int8_linear_blockscale(xq, wq, xs, ws, b, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert tim.int8_linear_blockscale.launches == launches + 1
        assert_gemm_close(out, tim.int8_linear_blockscale_reference(xq, wq, xs, ws, b,
                                                                    out_dtype=out_dtype))


@pytest.mark.parametrize("m,d", [(128 * 197, 768), (RAGGED_M, 768), (16 * 197 + 5, 768), (37, 64),
                                 (9, 1024)])
def test_ln_quantize_kernels_match_plain_versions(cuda_device, m, d):
    x, gamma, beta, inv_a = producer_inputs(m, d, cuda_device)
    launches = (tim.ln_quantize.launches, tim.ln_quantize_static3.launches)
    q, s = tim.ln_quantize(x, gamma, beta)
    rq, rs = tim.ln_quantize_reference(x, gamma, beta)
    three = tim.ln_quantize_static3(x.reshape(1, m, d), gamma, beta, inv_a)
    torch.cuda.synchronize()
    assert (tim.ln_quantize.launches, tim.ln_quantize_static3.launches) == (launches[0] + 1,
                                                                            launches[1] + 1)
    assert s.shape == rs.shape == (1, m)
    assert_within_one_int8_step(q, rq)
    torch.testing.assert_close(s, rs, rtol=1e-6, atol=0)
    torch.testing.assert_close(three.reshape(m, d), tim.ln_quantize_static(x, gamma, beta, inv_a),
                               rtol=0, atol=0)


def test_int8_gemm_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    xq, wq, xs, ws, b = gemm_inputs(8, 64, 96, cuda_device)
    with pytest.raises(TypeError, match="int8"):
        tim.int8_linear(xq.float(), wq, xs, ws, b)
    with pytest.raises(ValueError, match="divisible by 32"):
        tim.int8_linear(xq[:, :48].contiguous(), wq[:48], xs, ws, b)
    with pytest.raises(ValueError, match="lies on"):
        tim.int8_linear(xq, wq, xs.cpu(), ws, b)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tim.int8_linear(xq, wq, xs, ws, b, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="wider"):
        tim.int8_linear_gelu_quant(*gemm_inputs(8, 64, 2048, cuda_device), block_n=2048)
    with pytest.raises(ValueError, match="multiples of 32"):
        tim.int8_linear_blockscale(xq, wq, torch.ones((4, 8), device=cuda_device), ws, b)
    x, gamma, beta, _ = producer_inputs(8, 64, cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        tim.ln_quantize(x.float(), gamma, beta)


def plain_tier_kernels(monkeypatch):
    """Send the dynamic tiers' kernels to their plain versions (same card)."""
    for name in ("ln_quantize", "int8_linear", "int8_linear_gelu_quant", "int8_linear_blockscale"):
        monkeypatch.setattr(tquant, name, getattr(tim, name + "_reference"))
    monkeypatch.setattr(tquant, "attention_core", lambda qkv, heads, *, causal, kv_len, impl:
                        mha_packed_reference(qkv, heads, causal, kv_len))


@pytest.mark.parametrize("tower", ["image", "text"])
@pytest.mark.parametrize("tier", ["hybrid", "pallas"])
def test_dynamic_tiers_through_the_kernels_match_plain_versions(cuda_device, monkeypatch, tier,
                                                                tower):
    """The tiny towers on the card (widths 64, 192, 256: the kernels' shapes)
    on each tier through its kernels, against the same tier with the plain
    versions (same payload), and each kernel's launches per block."""
    cfg = tclip.CLIPConfig.tiny()
    params = tree_to(tclip.init_clip_params(torch.Generator().manual_seed(0), cfg), cuda_device)
    gen = torch.Generator().manual_seed(1)
    if tower == "image":
        qv = tquant.quantize_vision_tower(params)
        x = torch.randn((8, 32, 32, 3), generator=gen).to(cuda_device)
        encode, layers = tquant.encode_image_int8, cfg.vision.layers
    else:
        qv = tquant.quantize_text_tower(params)
        x = torch.randint(1, 1000, (8, 77), generator=gen).to(cuda_device)
        encode, layers = tquant.encode_text_int8, cfg.text.layers
    counters = (tim.ln_quantize, tim.int8_linear, tim.int8_linear_gelu_quant,
                tim.int8_linear_blockscale)
    before = [c.launches for c in counters]
    got = encode(qv, x, cfg, gemm_impl=tier).double()
    torch.cuda.synchronize()
    per_block = {"hybrid": (2, 0, 1, 1), "pallas": (2, 2, 1, 1)}[tier]
    assert [c.launches - n for c, n in zip(counters, before)] == [layers * k for k in per_block]
    plain_tier_kernels(monkeypatch)
    want = encode(qv, x, cfg, gemm_impl=tier).double()
    assert got.shape == (8, cfg.embed_dim) and bool(torch.isfinite(got).all())
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).min().item()
    err = (got - want).abs().max().item()
    rms = want.pow(2).mean().sqrt().item()
    assert cos >= 0.9999 and err <= 5e-3 * rms + 1e-6, (tier, tower, cos, err, rms)


# -- the tensor-parallel head split: rank r of nm computes its heads of the full packed qkv --

class _Layout:
    def __init__(self, rank, nm):
        self.model_rank, self.n_model = rank, nm


def _ranks(fn, nm):
    outs = []
    try:
        for r in range(nm):
            tms.set_tp_mesh(_Layout(r, nm))
            outs.append(fn(r))
    finally:
        tms.set_tp_mesh(None)
    return outs


@pytest.mark.parametrize("nm", [2, 4])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,causal", [(128, 197, 12, False), (32, 77, 8, True)])
def test_mha_packed_tp_kernel_matches_plain_and_the_whole_head_kernel(cuda_device, dtype, atol,
                                                                      b, s, h, causal, nm):
    """Each rank's kernel against its plain version; the ranks side by side
    are the whole-head kernel's output bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((b, s, 3 * h * 64), generator=g, device=cuda_device).to(dtype)
    launches = tms.fused_mha_packed_tp.launches
    outs = _ranks(lambda r: tms.fused_mha_packed_tp(x, h, causal=causal), nm)
    torch.cuda.synchronize()
    assert tms.fused_mha_packed_tp.launches == launches + nm
    for r, out in enumerate(outs):
        assert out.dtype == dtype and out.shape == (b, s, h * 64 // nm)
        torch.testing.assert_close(out.float(), tms.mha_packed_tp_plain(
            x, h, r, nm, causal=causal).float(), rtol=0, atol=atol)
    assert torch.equal(torch.cat(outs, dim=-1), fused_mha_packed(x, h, causal=causal))


# mode -> (knobs, whether the static softmax's constant is given, the wrapper's
# arguments); the text tower's causal shape takes the row max
TP_Q3I_MODES = {
    "static": ({}, True, {}), "rowmax": ({}, False, {}), "causal": ({}, False, {"causal": True}),
    "exp2i": ({"TEAM_QI_SOFTMAX": "exp2i"}, True, {}),
    "reduce": ({"TEAM_QI_ROWSUM": "reduce"}, True, {}),
    "reduce_defer": ({"TEAM_QI_ROWSUM": "reduce"}, False, {"defer_norm": True}),
    "reduce_defer-static": ({"TEAM_QI_ROWSUM": "reduce"}, True, {"defer_norm": True}),
    "pv_int8": ({}, False, {"pv_int8": True}),
    "pv_int8-static": ({}, True, {"pv_int8": True}),
    "pv_int8_defer": ({}, True, {"pv_int8": True, "defer_norm": True}),
}


@pytest.mark.parametrize("nm", [2, 4])
@pytest.mark.parametrize("mode", list(TP_Q3I_MODES))
def test_q3i_tp_kernel_matches_plain_and_the_whole_head_kernel(cuda_device, monkeypatch, nm, mode):
    b, s, h = (32, 77, 8) if mode == "causal" else (128, 197, 12)
    qkv, deq, qks, oinv, m2 = q3i_inputs(b, s, h, cuda_device, seed=4)
    env, static, args = TP_Q3I_MODES[mode]
    kw = {"qk_m2": m2 if static else None, "causal": False, "pv_int8": False,
          "defer_norm": False, **args}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    launches = tms.fused_mha_packed_q3i_tp.launches
    outs = _ranks(lambda r: tms.fused_mha_packed_q3i_tp(qkv, deq, qks, oinv, h, **kw), nm)
    torch.cuda.synchronize()
    assert tms.fused_mha_packed_q3i_tp.launches == launches + nm
    limit = pv_int8_limit(deq, oinv) if kw["pv_int8"] else 1
    for r, out in enumerate(outs):
        assert_within_one_int8_step(out, tms.mha_packed_q3i_tp_plain(qkv, deq, qks, oinv, h, r, nm,
                                                                     **kw), limit)
    assert torch.equal(torch.cat(outs, dim=-1), fused_mha_packed_q3i(qkv, deq, qks, oinv, h, **kw))


# ---------------------------------------------------------------------------
# #4 fused_mha_short_v2, #29 the q3i decomposition variants, #26 the u8
# normalize, and the bicubic resize on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_len", [None, 150])
@pytest.mark.parametrize("exp_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 0.0), (torch.bfloat16, 2.0 ** -7)])
def test_mha_short_v2_kernel_matches_plain_version(cuda_device, dtype, rtol, exp_dtype, kv_len):
    """float32 within 1e-5; bfloat16 within one output step (2^-7 |ref|) and 1e-5."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    q, k, v = (torch.randn((16, 12, 197, 64), generator=g, device=cuda_device).to(dtype)
               for _ in range(3))
    launches = tms.fused_mha_short_v2.launches
    out = tms.fused_mha_short_v2(q, k, v, kv_len, exp_dtype=exp_dtype, q_pad=128)
    torch.cuda.synchronize()
    assert tms.fused_mha_short_v2.launches == launches + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), tms.mha_short_v2_reference(
        q, k, v, kv_len, exp_dtype).float(), rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("b", [16, 128])
@pytest.mark.parametrize("kv_len", [None, 150])
def test_mha_short_v2_switches_take_effect(cuda_device, kv_len, b):
    """On bf16 inputs the deferred normalise and the bf16 exp each change the
    kernel's output, and each brings it nearer the plain version of its own
    arithmetic: fewer outputs differ from it than from the kernel without it
    (#3 for the normalise, the f32 exp for the exp)."""
    g = torch.Generator(device=cuda_device).manual_seed(10)
    q, k, v = (torch.randn((b, 12, 197, 64), generator=g, device=cuda_device).to(torch.bfloat16)
               for _ in range(3))
    v1 = tms.fused_mha_short(q, k, v, kv_len)
    f32exp = tms.fused_mha_short_v2(q, k, v, kv_len)
    bf16exp = tms.fused_mha_short_v2(q, k, v, kv_len, exp_dtype=torch.bfloat16)
    for out, without, exp_dtype in ((f32exp, v1, torch.float32), (bf16exp, f32exp, torch.bfloat16)):
        ref = tms.mha_short_v2_reference(q, k, v, kv_len, exp_dtype)
        assert not torch.equal(out, without)
        assert (out != ref).sum() < (without != ref).sum()


def _bf16_step(x):
    """One bf16 step (unit in the last place) at each ``x >= 0``."""
    _, expo = torch.frexp(x.clamp_min(2.0 ** -126))  # x = m 2^e, m in [0.5, 1)
    return torch.ldexp(torch.ones_like(x), expo - 8)


def assert_within_bf16_steps(out, ref, steps: int = 2):
    """A bf16 attention output ``[..., Dh]`` within ``steps`` bf16 steps of
    |ref|, plus one step of the largest |ref| in its row, plus 1e-5. The
    row's step covers a probability p_j rounded to bf16 on the other side of
    an edge (its f32 value one ulp apart, the exp or the sum in another
    order): that moves each output of the row by at most 2^-8 p_j |v_j|,
    which small outputs of a row of near-uniform p (the probes' inputs) do
    not cover by their own steps."""
    assert out.shape == ref.shape and out.dtype == ref.dtype == torch.bfloat16
    r = ref.float()
    err = (out.float() - r).abs()
    limit = 1e-5 + steps * _bf16_step(r.abs()) + _bf16_step(r.abs().amax(dim=-1, keepdim=True))
    assert bool((err <= limit).all()), (err / limit).max().item()


@pytest.mark.parametrize("kv_len", [None, 150])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mha_short_v2_kernel_at_the_vision_batch(cuda_device, dtype, kv_len):
    """B=128, S=197, H=12, both exponentials: float32 within 1e-5, bfloat16
    within two bf16 steps of |ref| plus one of its row's largest |ref| plus
    1e-5 (``assert_within_bf16_steps``)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((128, 12, 197, 64), generator=g, device=cuda_device).to(dtype)
               for _ in range(3))
    for exp_dtype in (torch.float32, torch.bfloat16):
        out = tms.fused_mha_short_v2(q, k, v, kv_len, exp_dtype=exp_dtype)
        ref = tms.mha_short_v2_reference(q, k, v, kv_len, exp_dtype)
        torch.cuda.synchronize()
        if dtype == torch.bfloat16:
            assert_within_bf16_steps(out, ref)
        else:
            torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["all", "qpad128"])
def test_attention_probe_kernels_on_the_probes_own_inputs(cuda_device, mode):
    """Each kernel implementation of ``scripts/attn_shootout`` (B=256) on the
    inputs of its first two chained layers, the probe's first input and tanh
    of the kernel's output on it, within ``assert_within_bf16_steps`` of the
    plain version."""
    from team_tpu_torch.scripts import attn_shootout as sh

    plains = {  # attn_shootout's labels -> the plain version
        "mha_short v1": lambda x: tms.mha_short_reference(x, x, x, sh.S),
        "mha_short v2 f32exp": lambda x: tms.mha_short_v2_reference(x, x, x, sh.S),
        "mha_short v2 bf16exp": lambda x: tms.mha_short_v2_reference(x, x, x, sh.S,
                                                                      torch.bfloat16),
        "v2 qpad=128 (deferred norm)": lambda x: tms.mha_short_v2_reference(x, x, x, sh.S),
        "v2 qpad=128 bf16exp": lambda x: tms.mha_short_v2_reference(x, x, x, sh.S,
                                                                     torch.bfloat16),
    }
    x0 = sh.make_inputs(sh.B, cuda_device, n=1)[0]
    kernels = {label: attn for label, attn in sh.implementations(mode).items()
               if label != "plain (xla_attention)"}
    assert kernels and set(kernels) <= set(plains)
    for label, attn in kernels.items():
        x = x0
        for _ in range(2):
            out = attn(x, x, x)
            ref = plains[label](x)
            torch.cuda.synchronize()
            assert_within_bf16_steps(out, ref)
            x = torch.tanh(out)


@pytest.mark.parametrize("b", [32, 128])
@pytest.mark.parametrize("oinv_range", [(20.0, 60.0), (0.5, 2.0)], ids=["script_oinv", "unclipped"])
@pytest.mark.parametrize("variant", list(tms.Q3I_VARIANTS))
def test_q3i_variant_kernels_match_plain_versions(cuda_device, variant, oinv_range, b):
    from team_tpu_torch.scripts import r4_attn_decomp as r4

    qkv, qks, qkm2, _ = r4.make_inputs(b, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    lo, hi = oinv_range
    oinv = torch.rand((1, r4.D), generator=g, device=cuda_device) * (hi - lo) + lo
    launches = tms.fused_mha_q3i_variant.launches[variant]
    out = tms.fused_mha_q3i_variant(qkv, qks, qkm2, oinv, r4.H, variant)
    torch.cuda.synchronize()
    assert tms.fused_mha_q3i_variant.launches[variant] == launches + 1
    ref = tms.mha_q3i_variant_reference(qkv, qks, qkm2, oinv, r4.H, variant)
    if variant == "copy":
        assert torch.equal(out, ref)
        return
    assert torch.isfinite(tms.mha_q3i_variant_float(qkv, qks, qkm2, oinv, r4.H, variant)).all()
    assert_within_one_int8_step(out, ref)


def test_q3i_variant_kernels_on_the_probes_own_inputs(cuda_device):
    """Each variant on ``scripts/r4_attn_decomp``'s own inputs (B=256), its
    first layer (from the second on, full's inputs are mostly +-127 and its
    exp2 overflows to inf in the plain version too): copy bit for bit, the
    others within one int8 step on under 1 % of the outputs, their float
    outputs checked finite first."""
    from team_tpu_torch.scripts import r4_attn_decomp as r4

    qkv, qks, qkm2, oinv = r4.make_inputs(r4.B, cuda_device)
    for variant in tms.Q3I_VARIANTS:
        out = tms.fused_mha_q3i_variant(qkv, qks, qkm2, oinv, r4.H, variant)
        ref = tms.mha_q3i_variant_reference(qkv, qks, qkm2, oinv, r4.H, variant)
        torch.cuda.synchronize()
        if variant == "copy":
            assert torch.equal(out, ref)
            continue
        assert torch.isfinite(tms.mha_q3i_variant_float(qkv, qks, qkm2, oinv, r4.H, variant)).all()
        assert_within_one_int8_step(out, ref)


def test_q3i_variant_full_is_the_packed_q3i_kernel(cuda_device):
    from team_tpu_torch.scripts import r4_attn_decomp as r4

    qkv, qks, qkm2, oinv = r4.make_inputs(8, cuda_device)
    ones = torch.ones((1, 3 * r4.D), device=cuda_device)
    assert torch.equal(tms.fused_mha_q3i_variant(qkv, qks, qkm2, oinv, r4.H, "full"),
                       fused_mha_packed_q3i(qkv, ones, qks, oinv, r4.H, qk_m2=qkm2))


@pytest.mark.parametrize("b,s", [(1, 16), (8, 224), (128, 224), (3, 5)])
def test_normalize_kernel_is_bit_equal_to_plain_version(cuda_device, b, s):
    from team_tpu_torch.ops import preprocess as tpre

    g = torch.Generator(device=cuda_device).manual_seed(b)
    x = torch.randint(0, 256, (b, s, s, 3), generator=g, device=cuda_device, dtype=torch.uint8)
    if s == 16:  # every value in every channel
        x = torch.arange(256, dtype=torch.uint8, device=cuda_device).reshape(1, 16, 16, 1).expand(
            1, 16, 16, 3).contiguous()
    launches = tpre.normalize_uint8_kernel.launches
    out = tpre.normalize_uint8_kernel(x)
    torch.cuda.synchronize()
    assert tpre.normalize_uint8_kernel.launches == launches + 1
    assert torch.equal(out.view(torch.int32), tpre.normalize_uint8_plain(x).view(torch.int32))


@pytest.mark.parametrize("flip", [True, False])
@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (2, 256, 320, 3), (4, 32, 32, 3),
                                   (4, 256, 320, 3)], ids=["up", "down", "up-b4", "down-b4"])
def test_resize_on_the_card_matches_the_cpu(cuda_device, shape, flip):
    from team_tpu_torch.ops import preprocess as tpre

    x = torch.randint(0, 256, shape, generator=torch.Generator().manual_seed(1), dtype=torch.uint8)
    got = tpre.preprocess_batch(x.to(cuda_device), 224, flip=flip)
    assert tuple(got.shape) == (shape[0], 224, 224, 3)
    torch.testing.assert_close(got.cpu(), tpre.preprocess_batch(x, 224, flip=flip), rtol=0,
                               atol=1e-5)


def test_probe_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    from team_tpu_torch.ops import preprocess as tpre

    x = torch.zeros((1, 4, 4, 3), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):  # a view that is not contiguous
        tpre.normalize_uint8_kernel(x.transpose(1, 2))
    q = torch.zeros((1, 2, 8, 48), device=cuda_device)
    with pytest.raises(ValueError):  # head width 48 is not compiled
        tms.fused_mha_short_v2(q, q, q)
    qkv = torch.zeros((1, 40, 3 * 128), dtype=torch.int8, device=cuda_device)
    vec = torch.ones((1, 2), device=cuda_device)
    with pytest.raises(ValueError):  # qkonly needs S >= Dh
        tms.fused_mha_q3i_variant(qkv, vec, vec, torch.ones((1, 128), device=cuda_device), 2,
                                  "qkonly")


def _int8(shape, gen, device, lo=-127, hi=128):
    return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int8)


@pytest.mark.parametrize("m,k,n", [(256, 512, 384), (100, 96, 40)])
def test_probe_mm_int8_kernel_is_exact(cuda_device, m, k, n):
    from team_tpu_torch.ops import gemm_probe as gp

    g = torch.Generator(device=cuda_device).manual_seed(0)
    x, w = _int8((m, k), g, cuda_device), gp.column_major(_int8((k, n), g, cuda_device))
    launches = gp.probe_mm.launches
    out = gp.probe_mm(x, w)
    torch.cuda.synchronize()
    assert gp.probe_mm.launches == launches + 1 and out.dtype == torch.int32
    assert torch.equal(out, gp.probe_mm_reference(x, w))
    assert torch.equal(gp.probe_mm(x, w.contiguous()), out)  # another layout is copied


@pytest.mark.parametrize("values", ["int8", "normal"])
@pytest.mark.parametrize("m,k,n", [(256, 512, 384), (100, 48, 40)])
def test_probe_mm_bf16_kernel_matches_plain_version(cuda_device, m, k, n, values):
    from team_tpu_torch.ops import gemm_probe as gp

    g = torch.Generator(device=cuda_device).manual_seed(1)
    if values == "int8":
        x, w = _int8((m, k), g, cuda_device), _int8((k, n), g, cuda_device)
    else:
        x, w = (torch.randn(s, generator=g, device=cuda_device) for s in ((m, k), (k, n)))
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    out = gp.probe_mm(x, w, torch.float32)
    ref = gp.probe_mm_reference(x, w)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    assert bool(((out - ref).abs() <= gp.probe_mm_bf16_limit(x, w)).all())


@pytest.mark.parametrize("k", [32, 96, 4128])
@pytest.mark.parametrize("n", [8, 264, 4096])
@pytest.mark.parametrize("m", [1, 100, 129, 4096])
def test_probe_mm_int8_wgmma_kernel_is_exact_at_ragged_shapes(cuda_device, m, n, k):
    """#27 int8 on wgmma (probe_mm_kernel_wg_s8) at tile edges in every
    dimension: bit for bit the exact product."""
    from team_tpu_torch.ops import gemm_probe as gp

    g = torch.Generator(device=cuda_device).manual_seed(m + 7 * n + 13 * k)
    x, w = _int8((m, k), g, cuda_device), gp.column_major(_int8((k, n), g, cuda_device))
    launches = gp.probe_mm.launches
    out = gp.probe_mm(x, w)
    torch.cuda.synchronize()
    assert gp.probe_mm.launches == launches + 1
    assert torch.equal(out, gp.probe_mm_reference(x, w))


# (m, k, n, reps): the probe's widths, also at its full 2000 reps; one tile
# whose 132 ranges outnumber the reps (5) or hold none (0); m and n not
# multiples of the 128 x 256 tile, K not of a 128-byte stage
@pytest.mark.parametrize("m,k,n,reps", [(512, 768, 768, 100), (100, 64, 96, 70),
                                        (512, 768, 768, 2000), (100, 64, 96, 5),
                                        (100, 64, 96, 0), (200, 96, 264, 70)])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_mxu_ceiling_kernel_matches_plain_version(cuda_device, dtype, m, k, n, reps):
    """int8 bit for bit, bf16 within CEILING_BF16_SHARE of the largest |ref|;
    two launches bit for bit (the ranges' partials are added in order)."""
    from team_tpu_torch.ops import gemm_probe as gp

    g = torch.Generator(device=cuda_device).manual_seed(2)
    rows = m + 8 * 64
    if dtype == torch.int8:
        x, w = _int8((rows, k), g, cuda_device), _int8((k, n), g, cuda_device, -3, 4)
    else:
        x, w = ((torch.randn(s, generator=g, device=cuda_device) * 0.1).to(dtype)
                for s in ((rows, k), (k, n)))
    launches = gp.mxu_ceiling.launches
    out = gp.mxu_ceiling(x, gp.column_major(w), reps=reps, m=m)
    again = gp.mxu_ceiling(x, gp.column_major(w), reps=reps, m=m)
    ref = gp.mxu_ceiling_reference(x, w, reps=reps, m=m)
    torch.cuda.synchronize()
    assert gp.mxu_ceiling.launches == launches + 2 and tuple(out.shape) == (m, n)
    assert torch.equal(out, again)
    if dtype == torch.int8:
        assert torch.equal(out, ref)
    else:
        assert (out - ref).abs().max().item() <= gp.CEILING_BF16_SHARE * ref.abs().max().item()


# (B, S, K, N): the probe's widths (N at team_mlp_mega_max_n()); M under one
# 64-row tile (the cluster's second tile wholly past M); one row; K short of
# a 256-column proj pass and N of a 256-column fc chunk (a warpgroup's half
# wholly past N); 11 row tiles (an odd count: the last cluster's second tile
# past M) with N not a multiple of 128
@pytest.mark.parametrize("b,s,k,n", [(4, 197, 768, 3072), (3, 7, 64, 256), (1, 1, 32, 32),
                                     (2, 300, 96, 288), (5, 131, 288, 3040)])
def test_mlp_mega_kernel_matches_plain_version_and_its_3d_entry(cuda_device, b, s, k, n):
    from team_tpu_torch.ops import gemm_probe as gp

    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = _int8((b, s, k), g, cuda_device)
    w1, w2 = gp.column_major(_int8((k, n), g, cuda_device)), gp.column_major(_int8((n, k), g, cuda_device))
    s1 = torch.full((1, n), 2e-4, device=cuda_device)
    s2 = torch.full((1, k), 2e-4, device=cuda_device)
    qi = torch.full((1, n), 30.0, device=cuda_device)
    out3 = gp.mlp_mega_3d(x, w1, s1, w2, s2, qi)
    out2 = gp.mlp_mega_2d(x.reshape(b * s, k), w1, s1, w2, s2, qi, block_m=256)
    ref = gp.mlp_mega_reference(x, w1, s1, w2, s2, qi)
    torch.cuda.synchronize()
    assert torch.equal(out2.reshape(b, s, k), out3) and out3.dtype == torch.bfloat16
    assert all(bool(torch.isfinite(t).all()) for t in gp.mlp_mega_hidden(x, w1, s1, qi).values())
    limit = gp.mlp_mega_limit(ref, gp.mlp_mega_edge_rows(x, w1, s1, qi), s2)
    assert bool(((out3.float() - ref.float()).abs() <= limit).all())


def test_gemm_probe_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    from team_tpu_torch.ops import gemm_probe as gp

    z8 = torch.zeros((64, 48), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError):  # int8 K must be a multiple of 32
        gp.probe_mm(z8, torch.zeros((48, 8), dtype=torch.int8, device=cuda_device))
    for dtype, k in ((torch.int8, 48), (torch.bfloat16, 40)):
        x = torch.zeros((16 + 512, k), dtype=dtype, device=cuda_device)
        with pytest.raises(ValueError):  # K not a multiple of 32 (int8) or 16 (bf16)
            gp.mxu_ceiling(x, torch.zeros((k, 64), dtype=dtype, device=cuda_device), 4, 16)
    k, n = 64, 4096
    xm = torch.zeros((2, k), dtype=torch.int8, device=cuda_device)
    vn, vk = torch.ones((1, n), device=cuda_device), torch.ones((1, k), device=cuda_device)
    with pytest.raises(ValueError):  # the hidden block [64, N] does not fit
        gp.mlp_mega_2d(xm, torch.zeros((k, n), dtype=torch.int8, device=cuda_device), vn,
                       torch.zeros((n, k), dtype=torch.int8, device=cuda_device), vk, vn)


def test_mlp_mega_takes_its_widest_n_and_rejects_the_next(cuda_device):
    """N = team_mlp_mega_max_n() (3,072: hq [64, N] resident beside three
    10 KB stages) runs and counts a launch; N one k32 step wider raises
    before anything is launched."""
    from team_tpu_torch.ops import gemm_probe as gp

    n, k = gp._library().team_mlp_mega_max_n(), 64
    assert n == 3072
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = _int8((70, k), g, cuda_device)
    vk = torch.full((1, k), 2e-4, device=cuda_device)
    for width, ok in ((n, True), (n + 32, False)):
        w1 = gp.column_major(_int8((k, width), g, cuda_device))
        w2 = gp.column_major(_int8((width, k), g, cuda_device))
        vn, qi = torch.full((1, width), 2e-4, device=cuda_device), torch.full((1, width), 30.0,
                                                                             device=cuda_device)
        launches = gp.mlp_mega_2d.launches
        if ok:
            out = gp.mlp_mega_2d(x, w1, vn, w2, vk, qi)
            ref = gp.mlp_mega_reference(x, w1, vn, w2, vk, qi)
            torch.cuda.synchronize()
            limit = gp.mlp_mega_limit(ref, gp.mlp_mega_edge_rows(x, w1, vn, qi), vk)
            assert bool(((out.float() - ref.float()).abs() <= limit).all())
            assert gp.mlp_mega_2d.launches == launches + 1
        else:
            with pytest.raises(ValueError, match="at most 3072"):
                gp.mlp_mega_2d(x, w1, vn, w2, vk, qi)
            assert gp.mlp_mega_2d.launches == launches


def test_gemm_probe_kernels_on_the_probes_own_inputs(cuda_device):
    """#27, #28 and #30 on the draws of ``scripts/int8_probe`` (M = N = K =
    4096), ``int8_mxu_ceiling`` (its M, K and REPS) and
    ``r5_megakernel_probe`` (its batch): probe_mm int8 bit for bit the exact
    product, bf16 within ``probe_mm_bf16_limit``; mxu_ceiling int8 bit for
    bit, bf16 within ``CEILING_BF16_SHARE`` of the largest |ref|, both the
    same over two launches; mlp_mega_2d and _3d equal and within
    ``mlp_mega_limit`` (the float intermediate checked finite first)."""
    from team_tpu_torch.ops import gemm_probe as gp
    from team_tpu_torch.scripts import int8_mxu_ceiling as mc
    from team_tpu_torch.scripts import int8_probe as ip
    from team_tpu_torch.scripts import r5_megakernel_probe as r5

    xs, w = ip.make_inputs(ip.SIZE, cuda_device)
    x = xs[0]
    assert torch.equal(gp.probe_mm(x, w), gp.probe_mm_reference(x, w))
    xb, wb = x.to(torch.bfloat16), gp.column_major(w.to(torch.bfloat16))
    out = gp.probe_mm(xb, wb)
    assert bool(((out - gp.probe_mm_reference(xb, wb)).abs() <= gp.probe_mm_bf16_limit(xb,
                                                                                       wb)).all())
    del xs, w, x, xb, wb, out
    for dtype in (torch.int8, torch.bfloat16):
        x, w = mc.make_inputs(dtype, mc.M, mc.K, cuda_device)
        out, again = (gp.mxu_ceiling(x, w, mc.REPS, mc.M) for _ in range(2))
        ref = gp.mxu_ceiling_reference(x, w, mc.REPS, mc.M)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        if dtype == torch.int8:
            assert torch.equal(out, ref)
        else:
            assert (out - ref).abs().max().item() <= gp.CEILING_BF16_SHARE * ref.abs().max().item()
    params, inputs = r5.make_inputs(r5.B, 1, cuda_device)
    x, (w1, s1, w2, s2, qi) = inputs[0], params
    b, s, k = x.shape
    out3 = gp.mlp_mega_3d(x, w1, s1, w2, s2, qi)
    out2 = gp.mlp_mega_2d(x.reshape(b * s, k), w1, s1, w2, s2, qi)
    torch.cuda.synchronize()
    assert torch.equal(out2.reshape(x.shape), out3)
    assert all(bool(torch.isfinite(t).all()) for t in gp.mlp_mega_hidden(x, w1, s1, qi).values())
    ref = gp.mlp_mega_reference(x, w1, s1, w2, s2, qi)
    limit = gp.mlp_mega_limit(ref, gp.mlp_mega_edge_rows(x, w1, s1, qi), s2)
    assert bool(((out3.float() - ref.float()).abs() <= limit).all())


# ---------------------------------------------------------------------------
# the bf16 attention kernels on the tensor cores: the packed kernel that #1,
# #2, #3 and #4 share (csrc/mha_packed.cu) and the flash kernel #14
# (csrc/flash_attention.cu), both on the tile of csrc/mma_attention.cuh; f32
# keeps the CUDA-core kernels
# ---------------------------------------------------------------------------

# query and key tiles whole and ragged by one (16-key blocks, 64-row tiles,
# the 8- and 16-block logits windows)
TC_EDGE_S = [1, 15, 16, 17, 63, 64, 65, 255, 256, 257]


def unaligned_copy(t):
    """The same values, 2 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    start = (16 - buf.data_ptr() % 16) % 16 // t.element_size() + 1
    view = buf[start:start + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 2
    return view


def _head_views(qkv, h):
    b, s, d3 = qkv.shape
    return [t.reshape(b, s, h, d3 // 3 // h).permute(0, 2, 1, 3) for t in qkv.split(d3 // 3, -1)]


def _merge_heads(out):
    b, h, s, dh = out.shape
    return out.permute(0, 2, 1, 3).reshape(b, s, h * dh)


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("s", TC_EDGE_S)
def test_bf16_packed_kernels_at_the_tile_edges(cuda_device, s, dh):
    """#1 (causal and not) against its plain version; #3 on the head views
    with a key mask equal to #1 bit for bit; #2's two ranks side by side
    equal to #1 bit for bit."""
    b, h = 2, 2
    g = torch.Generator(device=cuda_device).manual_seed(s + dh)
    qkv = torch.randn((b, s, 3 * h * dh), generator=g, device=cuda_device).to(torch.bfloat16)
    for causal in (False, True):
        out = fused_mha_packed(qkv, h, causal=causal)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), mha_packed_reference(qkv, h, causal).float(),
                                   rtol=0, atol=2e-2)
        ranks = _ranks(lambda r: tms.fused_mha_packed_tp(qkv, h, causal=causal), 2)
        assert torch.equal(torch.cat(ranks, dim=-1), out)
    kv_len = s // 2 + 1
    short = tms.fused_mha_short(*_head_views(qkv, h), kv_len)
    assert torch.equal(_merge_heads(short), fused_mha_packed(qkv, h, kv_len=kv_len))


def _cuda_core_packed_bf16_smem(s, dh):
    """Shared memory of the CUDA-core bf16 packed kernel that the tensor-core
    one replaced (padded K/V, per-warp row buffers)."""
    return (2 * s * (dh + 2) * 2 + 15) // 16 * 16 + 8 * (s + dh) * 4


@pytest.mark.parametrize("dh", [32, 64, 128])
def test_bf16_packed_kernel_at_the_longest_s_and_one_past(cuda_device, dh):
    lib = tms._library()
    fits = lambda s: lib.team_mha_packed_smem_bytes(1, s, dh, 0) <= tms._SMEM_LIMIT  # noqa: E731
    longest = max(s for s in range(1, 4096) if fits(s))
    old = max(s for s in range(1, 4096) if _cuda_core_packed_bf16_smem(s, dh) <= tms._SMEM_LIMIT)
    assert longest >= old  # every S the CUDA-core kernel took, and more
    g = torch.Generator(device=cuda_device).manual_seed(dh)
    qkv = torch.randn((1, longest, 3 * dh), generator=g, device=cuda_device).to(torch.bfloat16)
    for causal in (False, True):
        out = fused_mha_packed(qkv, 1, causal=causal)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), mha_packed_reference(qkv, 1, causal).float(),
                                   rtol=0, atol=2e-2)
    launches = fused_mha_packed.launches
    with pytest.raises(ValueError, match="shared memory"):
        fused_mha_packed(torch.zeros((1, longest + 1, 3 * dh), dtype=torch.bfloat16,
                                     device=cuda_device), 1)
    assert fused_mha_packed.launches == launches


@pytest.mark.parametrize("b,s,h,dh,causal,kv_len", [
    (3, 77, 8, 64, True, 60), (2, 130, 4, 32, True, 100), (2, 197, 2, 128, False, 150),
    (2, 300, 2, 64, True, 250), (2, 33, 4, 32, False, 1)])
def test_bf16_packed_kernels_take_key_masks_and_unaligned_inputs(cuda_device, b, s, h, dh, causal,
                                                                 kv_len):
    """Causal with kv_len < S, one key, dh 32, 64 and 128; inputs 2 bytes past
    a 16-byte boundary are copied by the wrappers and give the same output."""
    g = torch.Generator(device=cuda_device).manual_seed(b * s)
    qkv = torch.randn((b, s, 3 * h * dh), generator=g, device=cuda_device).to(torch.bfloat16)
    out = fused_mha_packed(qkv, h, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), mha_packed_reference(qkv, h, causal, kv_len).float(),
                               rtol=0, atol=2e-2)
    moved = unaligned_copy(qkv)
    launches = (fused_mha_packed.launches, tms.fused_mha_short.launches)
    assert torch.equal(fused_mha_packed(moved, h, causal=causal, kv_len=kv_len), out)
    ranks = _ranks(lambda r: tms.fused_mha_packed_tp(moved, h, causal=causal, kv_len=kv_len), 2)
    assert torch.equal(torch.cat(ranks, dim=-1), out)
    q, k, v = (unaligned_copy(t) for t in _head_views(qkv, h))
    short = tms.fused_mha_short(q, k, v, kv_len)
    assert (fused_mha_packed.launches, tms.fused_mha_short.launches) == (launches[0] + 1,
                                                                         launches[1] + 1)
    torch.testing.assert_close(short.float(), tms.mha_short_reference(q, k, v, kv_len).float(),
                               rtol=0, atol=2e-2)
    assert torch.equal(short, tms.fused_mha_short(*_head_views(qkv, h), kv_len))


@pytest.mark.parametrize("b,h,s,dh,kv_len", [(4, 4, 77, 32, None), (2, 4, 300, 64, 250),
                                             (2, 2, 130, 128, None)])
def test_bf16_v2_switches_take_effect_at_other_widths(cuda_device, b, h, s, dh, kv_len):
    """As test_mha_short_v2_switches_take_effect, at other widths and S (#4's
    bf16 kernel beside the tensor-core #3): each switch changes the output and
    brings it nearer its own plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    q, k, v = (torch.randn((b, h, s, dh), generator=g, device=cuda_device).to(torch.bfloat16)
               for _ in range(3))
    v1 = tms.fused_mha_short(q, k, v, kv_len)
    f32exp = tms.fused_mha_short_v2(q, k, v, kv_len)
    bf16exp = tms.fused_mha_short_v2(q, k, v, kv_len, exp_dtype=torch.bfloat16)
    for out, without, exp_dtype in ((f32exp, v1, torch.float32), (bf16exp, f32exp, torch.bfloat16)):
        ref = tms.mha_short_v2_reference(q, k, v, kv_len, exp_dtype)
        torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=2e-2)
        assert not torch.equal(out, without)
        assert (out != ref).sum() < (without != ref).sum()


# #4's bf16 kernel (mha_v2_kernel_tc) at the edges of its 16-key blocks, of
# its logits windows (4, 7 or 8 blocks a key half; dh 128 at 4, two passes
# past 128 keys) and of its 64-row tiles: (S, dh, kv_len)
V2_EDGE_CASES = [(s, dh, kv) for dh in (32, 64, 128)
                 for s in (1, 15, 16, 17, 77, 197, 208, 300, 577)
                 for kv in dict.fromkeys((None, 1, s - 7 if s > 7 else None))]


def _v2_fits(s, dh):
    return tms._library().team_mha_packed_smem_bytes(1, s, dh, 1) <= tms._SMEM_LIMIT


@pytest.mark.parametrize("exp_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,dh,kv_len", V2_EDGE_CASES)
def test_bf16_v2_kernel_at_the_tile_and_window_edges(cuda_device, s, dh, kv_len, exp_dtype):
    """#4's tensor-core kernel against its plain version at the existing
    tolerance (one output step, 2^-7 of |ref|, plus 1e-5); a shape whose K
    and V do not fit shared memory (S=577 at dh 128) raises."""
    g = torch.Generator(device=cuda_device).manual_seed(s * 131 + dh)
    q, k, v = (torch.randn((2, 3, s, dh), generator=g, device=cuda_device).to(torch.bfloat16)
               for _ in range(3))
    if not _v2_fits(s, dh):
        with pytest.raises(ValueError, match="shared memory"):
            tms.fused_mha_short_v2(q, k, v, kv_len, exp_dtype=exp_dtype)
        return
    launches = tms.fused_mha_short_v2.launches
    out = tms.fused_mha_short_v2(q, k, v, kv_len, exp_dtype=exp_dtype)
    torch.cuda.synchronize()
    assert tms.fused_mha_short_v2.launches == launches + 1
    torch.testing.assert_close(out.float(), tms.mha_short_v2_reference(
        q, k, v, kv_len, exp_dtype).float(), rtol=2.0 ** -7, atol=1e-5)


def test_v2_tensor_core_kernel_issues_hmma(cuda_device):
    """Every instantiation of #4's bf16 kernel runs its PV on the tensor
    cores: dh 32 and 64 at windows of 4, 7 and 8 blocks, dh 128 at 4, each
    with the f32 and the bf16 exponential."""
    tms.build()
    counts = [n for fn, n in _hmma_per_kernel("mha_packed.cu").items() if "mha_v2_kernel_tc" in fn]
    assert len(counts) == 14 and min(counts) > 0, counts


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 577, 1024])
def test_bf16_flash_kernel_at_the_tile_edges(cuda_device, s, dh):
    """Every key, one key, causal, and causal with kv_len < S."""
    b, h = 2, 2
    g = torch.Generator(device=cuda_device).manual_seed(s + dh)
    q, k, v = (torch.randn((b, h, s, dh), generator=g, device=cuda_device).to(torch.bfloat16)
               for _ in range(3))
    for causal, kv_len in ((False, None), (False, 1), (True, None), (True, (s + 1) // 2)):
        out = flash_attention(q, k, v, kv_len, causal=causal)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            out.float(), flash_attention_reference(q, k, v, kv_len, causal=causal).float(),
            rtol=0, atol=2e-2)


def test_bf16_flash_kernel_takes_head_split_and_unaligned_views(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(12)
    b, s, h, dh = 4, 197, 12, 64
    qkv = torch.randn((b, s, 3 * h * dh), generator=g, device=cuda_device).to(torch.bfloat16)
    q, k, v = _head_views(qkv, h)
    out = flash_attention(q, k, v, 150, causal=True)
    torch.testing.assert_close(out.float(), flash_attention_reference(
        q, k, v, 150, causal=True).float(), rtol=0, atol=2e-2)
    assert out.permute(0, 2, 1, 3).is_contiguous()  # heads merge back without a copy
    launches = flash_attention.launches
    moved = flash_attention(*_head_views(unaligned_copy(qkv), h), 150, causal=True)
    assert flash_attention.launches == launches + 1
    assert torch.equal(moved, out)


def _opcode_per_kernel(source, opcode):
    """source's kernels by name -> the SASS lines that hold ``opcode``."""
    import os
    import subprocess

    from team_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build._target(source))], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    lines, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            lines[name] = []
        elif name is not None and opcode in line:
            lines[name].append(line)
    return lines


def _hmma_per_kernel(source):
    """source's kernels by name -> the HMMA instructions in their SASS."""
    return {fn: len(found) for fn, found in _opcode_per_kernel(source, "HMMA").items()}


def _build_every_source():
    from team_tpu_torch.ops import gemm_probe as gp

    tms.build()
    flash_build()
    tim.build()
    gp.build()


def _per_kernel(source, opcode):
    """``sass_tables``' kernels of ``source`` -> the ``opcode`` lines of each
    of their instantiations, each mangled name taken by the first name it
    holds, the opcode's issuers first (a tensor-core name holds its
    CUDA-core kernel's)."""
    issuing, other = {**sass_tables.TC_SOURCES, **sass_tables.GMMA_SOURCES}[source]
    kinds = {k: [] for k in (*issuing, *other)}
    for fn, lines in _opcode_per_kernel(source, opcode).items():
        kind = next((k for k in issuing if k in fn), None) or next((k for k in other if k in fn),
                                                                  None)
        if kind is not None:
            kinds[kind].append(lines)
    return kinds


def _assert_issued(table, source, opcode, exempt=None):
    """Every instantiation of each issuing kernel of ``table[source]`` issues
    ``opcode`` but ``exempt``'s count of them, none of the others does, and
    each kernel has its ``sass_tables.INSTANCES``."""
    issuing, other = table[source]
    kinds = _per_kernel(source, opcode)
    for kernel in issuing:
        counts = [len(lines) for lines in kinds[kernel]]
        assert counts and counts.count(0) == (exempt or {}).get(kernel, 0), (kernel, counts)
    for kernel in other:
        counts = [len(lines) for lines in kinds[kernel]]
        assert counts and max(counts) == 0, (kernel, counts)
    for kernel, lines in kinds.items():
        assert len(lines) == sass_tables.INSTANCES.get(kernel, len(lines)), (kernel, len(lines))
    return kinds


@pytest.mark.parametrize("source", list(sass_tables.TC_SOURCES))
def test_tensor_core_kernels_issue_hmma_and_cuda_core_kernels_none(cuda_device, source):
    """The explicit dispatch on the dtype: every bf16 kernel of #1-#4, #12,
    #13 and #14 (every head width and logits window) and of the int8
    attention's PV runs its products on the tensor cores, but the
    instantiations of #29's probe cuts that run no PV; every f32 kernel, and
    the CLS kernel, on the CUDA cores."""
    _build_every_source()
    _assert_issued(sass_tables.TC_SOURCES, source, "HMMA", sass_tables.NO_PV_INSTANCES.get(source))


def _spill_checked() -> dict:
    """source -> the kernels that may not spill: every tensor-core (mma.sync
    or wgmma) kernel of the tables, and ``NO_SPILL_CUDA_CORE``."""
    checked = {}
    for table in (sass_tables.TC_SOURCES, sass_tables.GMMA_SOURCES, sass_tables.IMMA_SOURCES):
        for source, (issuing, _) in table.items():
            checked.setdefault(source, set()).update(issuing)
    for source, kernels in sass_tables.NO_SPILL_CUDA_CORE.items():
        checked.setdefault(source, set()).update(kernels)
    return checked


@pytest.mark.parametrize("source", sorted(_spill_checked()))
def test_tensor_core_kernels_do_not_spill(cuda_device, source, tmp_path):
    """ptxas's report of the source (this process's build of it, else a
    build of its own): no tensor-core kernel and no kernel of
    ``NO_SPILL_CUDA_CORE`` spills, and no kernel's wgmma is serialized
    (C7514: accumulators read while their group may be in flight)."""
    import subprocess

    from team_tpu_torch.ops import _build

    log = _build.BUILD_LOGS.get(source)
    if log is None:
        out = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(tmp_path / "k.so"),
                              str(_build.CSRC_DIR / source)], capture_output=True, text=True,
                             timeout=900)
        assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
        log = out.stdout + out.stderr
    kernels = _spill_checked()[source]
    seen, name = set(), None
    for line in log.splitlines():
        assert "C7514" not in line, line
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name is not None and any(k in name for k in kernels):
            seen.update(k for k in kernels if k in name)
            spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", line)]
            assert not any(spills), (name, line.strip())
    assert seen == kernels, kernels - seen


# ---------------------------------------------------------------------------
# the wgmma + TMA GEMMs (csrc/wgmma_gemm.cuh): #21 int8_linear_gelu_quant at
# bn 256 and 512 (csrc/int8_gemm.cu) and #27 probe_mm in bf16
# (csrc/gemm_probe.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [16, 48, 4096])
@pytest.mark.parametrize("m,n", [(1, 8), (127, 264), (129, 520), (300, 248)])
def test_probe_mm_bf16_wgmma_kernel_at_the_tile_edges(cuda_device, m, n, k):
    """M and N not multiples of the 128 x 256 tile, K under and over the
    64-column stage: within (K/16 + 1) ulps of |x|@|w|."""
    from team_tpu_torch.ops import gemm_probe as gp

    g = torch.Generator(device=cuda_device).manual_seed(5)
    x, w = (torch.randn(s, generator=g, device=cuda_device).to(torch.bfloat16)
            for s in ((m, k), (k, n)))
    launches = gp.probe_mm.launches
    out = gp.probe_mm(x, gp.column_major(w))
    ref = gp.probe_mm_reference(x, w)
    torch.cuda.synchronize()
    assert gp.probe_mm.launches == launches + 1 and tuple(out.shape) == (m, n)
    assert bool(((out - ref).abs() <= gp.probe_mm_bf16_limit(x, w)).all())


@pytest.mark.parametrize("source", list(sass_tables.GMMA_SOURCES))
def test_wgmma_kernels_issue_gmma_and_mma_sync_kernels_none(cuda_device, source):
    """#15 (every epilogue and output type), #20 at bk a multiple of 128, #21
    at bn 256 and 512, #27 and #28 in int8 and bf16 and #30 run wgmma, each
    instantiation one of its kernel's GMMA forms and each form issued; the
    kernels on mma.sync (gemm_kernel: blockscale at other bk; gelu_quant at
    other bn) issue no GMMA."""
    _build_every_source()
    kinds = _assert_issued(sass_tables.GMMA_SOURCES, source, "GMMA")
    for kernel in sass_tables.GMMA_SOURCES[source][0]:
        forms = sass_tables.GMMA_MNEMONICS[kernel]
        assert all(any(f in line for f in forms for line in lines) for lines in kinds[kernel]), \
            (kernel, kinds[kernel])
        assert all(any(f in line for lines in kinds[kernel] for line in lines) for f in forms), \
            (kernel, forms)


# -- the bf16 towers' elementwise kernels (ops/tower_bf16.py) --

from team_tpu_torch.ops import tower_bf16 as ttb  # noqa: E402

# (rows, width, eps, gelu of the fc site): ViT-B/16 and SigLIP So400m/14-384
# at B=128, the text tower at 32 prompts
TOWER_SITES = {
    "vitb16": (128 * 197, 768, 1e-5, "none"),
    "siglip": (128 * 729, 1152, 1e-6, "tanh"),
    "text": (32 * 77, 512, 1e-5, "none"),
}
# (rows, N, gelu): each tower's qkv and fc GEMM outputs, SigLIP's pooling k/v
BIAS_SITES = [
    pytest.param(128 * 197, 2304, None, id="vitb16-qkv"),
    pytest.param(128 * 197, 3072, "none", id="vitb16-fc"),
    pytest.param(128 * 729, 3456, None, id="siglip-qkv"),
    pytest.param(128 * 729, 4304, "tanh", id="siglip-fc"),
    pytest.param(128 * 729, 2304, None, id="siglip-pool-kv"),
    pytest.param(128, 4304, "tanh", id="siglip-pool-fc"),
    pytest.param(32 * 77, 1536, None, id="text-qkv"),
    pytest.param(32 * 77, 2048, "none", id="text-fc"),
    pytest.param(37, 64, "tanh", id="ragged"),
]


def tower_inputs(rows, d, device, seed=0):
    """A residual stream of a few units, a GEMM output, a bf16 bias, a layer
    norm's float32 affine."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn((rows, d), generator=g, device=device)
         * (torch.rand((rows, 1), generator=g, device=device) * 3 + 0.5)).to(torch.bfloat16)
    y = torch.randn((rows, d), generator=g, device=device).to(torch.bfloat16)
    b = (torch.randn(d, generator=g, device=device) * 0.1).to(torch.bfloat16)
    gamma = torch.rand(d, generator=g, device=device) + 0.5
    beta = torch.rand(d, generator=g, device=device) * 0.4 - 0.2
    return x, y, b, gamma, beta


# the layer norms' outputs under this magnitude count at its bf16 step: there
# beta cancels gamma * (x - mean) * rstd, and the float32 sums' own rounding
# (about 2^-24 of the terms, 1e-7 to 1e-6 at these inputs) is several bf16
# steps of the tiny result, whatever the order of the sums
LN_FLOOR = 2.0 ** -10


def assert_rarely_one_bf16_step(got, want, share: float = 1e-3) -> float:
    """At most one bf16 step of the output's magnitude (floored at
    ``LN_FLOOR``), on under ``share`` of the outputs; returns the share."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    g, w = got.float(), want.float()
    step = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=LN_FLOOR))) - 7)
    diff = (g - w).abs()
    assert (diff <= step).all(), (diff / step).max().item()
    moved = (diff > 0).float().mean().item()
    assert moved < share, moved
    apart = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs() > 1
    largest = w.abs()[apart].max().item() if apart.any() else 0.0
    print(f"  {int(apart.sum())} outputs more than one bit pattern apart, |ref| up to "
          f"{largest:.3e}")
    return moved


@pytest.mark.parametrize("rows,n,gelu", BIAS_SITES)
@pytest.mark.parametrize("act", ["site", "bias"])
def test_bias_act_kernel_is_the_composition_bit_for_bit(cuda_device, rows, n, gelu, act):
    """The site's own activation, and the bias alone at each site."""
    gelu = gelu if act == "site" else None
    _, y, b, _, _ = tower_inputs(rows, n, cuda_device, seed=n)
    want = ttb.bias_act_reference(y, b, gelu)
    launches = ttb.bias_act.launches
    got = ttb.bias_act(y, b, gelu)
    torch.cuda.synchronize()
    assert ttb.bias_act.launches == launches + 1
    assert got.data_ptr() == y.data_ptr() and torch.equal(got, want)


@pytest.mark.parametrize("tower", list(TOWER_SITES))
@pytest.mark.parametrize("with_ln", [True, False], ids=["ln", "residual"])
def test_residual_ln_kernel_matches_the_composition(cuda_device, tower, with_ln):
    """x' bit for bit; the layer norm at most one bf16 step on under 0.1 %."""
    rows, d, eps, _ = TOWER_SITES[tower]
    x, y, b, gamma, beta = tower_inputs(rows, d, cuda_device, seed=d)
    affine = (gamma, beta) if with_ln else ()
    want, want_h = ttb.residual_ln_reference(x, y, b, *affine, eps=eps)
    launches = ttb.residual_ln.launches
    got, h = ttb.residual_ln(x, y, b, *affine, eps=eps)
    torch.cuda.synchronize()
    assert ttb.residual_ln.launches == launches + 1
    assert got.data_ptr() == y.data_ptr() and torch.equal(got, want)
    if with_ln:
        print(f"residual_ln {tower} {rows}x{d}: "
              f"{assert_rarely_one_bf16_step(h, want_h):.2e} of LN's outputs one step off")
    else:
        assert h is None


@pytest.mark.parametrize("site", ["vitb16", "siglip", "text", "cls-rows", "pool-rows", "ragged"])
def test_layer_norm_kernel_matches_the_composition(cuda_device, site):
    """Each tower's rows, ViT-B/16's CLS rows ``x[:, 0]`` (rows 197·768
    apart, no copy) and the attention-pool head's 128 rows: at most one bf16
    step on under 0.1 %."""
    if site in TOWER_SITES:
        rows, d, eps, _ = TOWER_SITES[site]
        x, _, _, gamma, beta = tower_inputs(rows, d, cuda_device, seed=rows)
    elif site == "cls-rows":
        x, _, _, gamma, beta = tower_inputs(128 * 197, 768, cuda_device, seed=3)
        x, eps = x.reshape(128, 197, 768)[:, 0], 1e-5
    elif site == "pool-rows":
        x, _, _, gamma, beta = tower_inputs(128, 1152, cuda_device, seed=4)
        eps = 1e-6
    else:
        x, _, _, gamma, beta = tower_inputs(37, 2048, cuda_device, seed=5)
        eps = 1e-5
    launches = ttb.layer_norm.launches
    got = ttb.layer_norm(x, gamma, beta, eps)
    torch.cuda.synchronize()
    assert ttb.layer_norm.launches == launches + 1
    share = assert_rarely_one_bf16_step(got, ttb.layer_norm_reference(x, gamma, beta, eps))
    print(f"layer_norm {site} {tuple(x.shape)}: {share:.2e} of the outputs one step off")


def test_tower_bf16_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    x, y, b, gamma, beta = tower_inputs(8, 64, cuda_device)
    assert ttb._library().team_tower_bf16_max_width() == ttb.MAX_WIDTH
    with pytest.raises(TypeError, match="bfloat16"):
        ttb.bias_act(y.float(), b)
    with pytest.raises(TypeError, match="bfloat16"):
        ttb.layer_norm(x.float(), gamma, beta)
    with pytest.raises(ValueError, match="divisible by 8"):
        ttb.residual_ln(x[:, :60], y[:, :60], b[:60])
    with pytest.raises(ValueError, match="lies on"):
        ttb.residual_ln(x, y, b, gamma.cpu(), beta)
    with pytest.raises(ValueError, match="wider"):
        ttb.layer_norm(torch.zeros((2, 2056), dtype=torch.bfloat16, device=cuda_device),
                       torch.ones(2056, device=cuda_device), torch.zeros(2056, device=cuda_device))
    with pytest.raises(RuntimeError, match="forward only"):
        ttb.bias_act(y.clone().requires_grad_(True), b)


@pytest.mark.parametrize("tower", ["image", "text"])
def test_a_bf16_tower_the_kernels_do_not_take_raises(cuda_device, tower):
    """A bf16 tower on the card takes the kernels at every width, so one they
    do not take (60, no multiple of 8) raises in their wrappers rather than
    running the composition."""
    v = tclip.VisionConfig(image_size=32, patch_size=16, width=60, layers=1, heads=2,
                           embed_dim=32)
    t = tclip.TextConfig(context_length=77, vocab_size=49408, width=60, layers=1, heads=2,
                         embed_dim=32)
    cfg = tclip.CLIPConfig(vision=v, text=t, embed_dim=32)
    params = tclip.cast_frozen_params(tclip.init_clip_params(torch.Generator().manual_seed(0), cfg),
                                      torch.bfloat16, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    with torch.no_grad(), pytest.raises(ValueError, match="divisible by 8"):
        if tower == "image":
            patches = torch.randn((2, v.grid ** 2, v.width), generator=g, device=cuda_device)
            tclip.encode_from_patches(params, patches.to(torch.bfloat16), cfg,
                                      compute_dtype=torch.bfloat16)
        else:
            tokens = torch.randint(1, 49000, (2, 77), generator=g, device=cuda_device)
            tclip.encode_text(params, tokens, cfg, compute_dtype=torch.bfloat16)


def _vitb16_bf16(device):
    cfg = tclip.CLIPConfig()
    params = tclip.cast_frozen_params(tclip.init_clip_params(torch.Generator().manual_seed(0), cfg),
                                      torch.bfloat16, device)
    return cfg, params


def _tower_counts():
    return (ttb.bias_act.launches, ttb.residual_ln.launches, ttb.layer_norm.launches)


def _other_order_ln(p, x, eps=1e-5):
    """``clip._layer_norm`` with its mean summed in another order (a sum
    over N) and the variance in two passes: as right as the composition's."""
    x32 = x.float()
    mean = x32.sum(dim=-1, keepdim=True) / x.shape[-1]
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return (((x32 - mean) * torch.rsqrt(var + eps)) * p["scale"] + p["bias"]).to(x.dtype)


def _gap(a, b):
    return 1 - torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=-1).min().item()


def _counted(fn):
    before = _tower_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, tuple(a - b for a, b in zip(_tower_counts(), before))


def test_vitb16_bf16_encode_launches_the_tower_kernels(cuda_device, monkeypatch, record_property):
    """One B=128 encode: a bias_act a GEMM bias (12 qkv, 12 fc with the GELU),
    a residual_ln a half (LN2, the next LN1; the last block's alone) and three
    layer norms (ln_pre, the first LN1, ln_post on the CLS rows); the text
    tower at 32 prompts (24, 24, 2). Their features lie no further (1 −
    cosine) from the composition's towers (the kernels switched off) than
    twice as far as the composition lies from itself with its layer norm's
    sums in another order (``_other_order_ln``): the layer norms' one-step
    differences compound over the blocks (1e-5 floors the yardstick); and
    never past 1e-4."""
    cfg, params = _vitb16_bf16(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    u8 = torch.randint(0, 256, (128, 196, 768), generator=g, device=cuda_device,
                       dtype=torch.uint8)
    tokens = torch.randint(1, 49000, (32, 77), generator=g, device=cuda_device)
    towers = {
        "image": (lambda: tclip.encode_image_patches_u8(params, u8, cfg,
                                                        compute_dtype=torch.bfloat16), (24, 24, 3)),
        "text": (lambda: tclip.encode_text(params, tokens, cfg, compute_dtype=torch.bfloat16),
                 (24, 24, 2)),
    }
    with torch.no_grad():
        got = {}
        launches = {}
        for name, (fn, want) in towers.items():
            got[name], counts = _counted(fn)
            assert counts == want, (name, counts)
            for kernel, n in zip(("bias_act", "residual_ln", "layer_norm"), counts):
                launches[kernel] = launches.get(kernel, 0) + n
        record_launches(record_property, launches)
        monkeypatch.setattr(tclip, "_tower_kernels", lambda x, shard=None: False)
        plain = {name: _counted(fn) for name, (fn, _) in towers.items()}
        monkeypatch.setattr(tclip, "_layer_norm", _other_order_ln)
        other = {name: fn() for name, (fn, _) in towers.items()}
    for name in towers:
        assert plain[name][1] == (0, 0, 0)
        gap, floor = _gap(got[name], plain[name][0]), _gap(plain[name][0], other[name])
        print(f"{name} tower: 1 - cosine to the composition {gap:.3e}, the composition's to "
              f"itself with another order of sums {floor:.3e}")
        assert gap <= 2 * max(floor, 1e-5) and gap <= 1e-4, (name, gap, floor)


def test_a_gradient_and_gradcam_launch_no_tower_kernel(cuda_device):
    """A bf16 tower whose tokens need a gradient runs the composition (and
    differentiates through #1), as Grad-CAM does in float32."""
    from team_tpu_torch.analysis.gradcam import grad_cam

    cfg = tclip.CLIPConfig.tiny()
    params = tclip.cast_frozen_params(tclip.init_clip_params(torch.Generator().manual_seed(0), cfg),
                                      torch.bfloat16, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    tokens = torch.randn((4, cfg.vision.grid ** 2, cfg.vision.width), generator=g,
                         device=cuda_device).to(torch.bfloat16).requires_grad_(True)
    before = _tower_counts()
    out = tclip.encode_from_patches(params, tokens, cfg, compute_dtype=torch.bfloat16)
    out.float().sum().backward()
    images = torch.randn((4, 32, 32, 3), generator=g, device=cuda_device)
    f32 = tclip.cast_frozen_params(tclip.init_clip_params(torch.Generator().manual_seed(0), cfg),
                                   torch.float32, cuda_device)
    target = torch.ones(cfg.embed_dim, device=cuda_device)
    cam = grad_cam(f32, images, target, cfg, attn_impl="auto")
    torch.cuda.synchronize()
    assert tokens.grad is not None and torch.isfinite(cam).all()
    assert _tower_counts() == before
