"""The order of summation of the int8 attention kernels on the tensor cores
(``csrc/mha_packed_q3i.cu``'s ``q3i_kernel_tc``, #7, #10, #11, #29;
``csrc/mha_packed_q.cu``'s ``mha_q_kernel_tc``, #5, #6), modelled in plain
PyTorch on the CPU and held against the plain versions within the limits
that the card tests set: at most one int8 step
on under 1 % of the outputs (the int8 PV: ``pv_int8_limit`` steps). So the
tolerance is known before the kernels run on a card.

The CLS kernel (``q3i_cls_kernel``, #8, #9) is modelled too: its l and p·v
sums in the order its 256 threads take them.

The model: q·k in m16n8 tiles of 16 keys (int8: exact; bf16: each 16-wide
k-step's sum rounded to f32, the steps added in order in f32); a row's sum l
as a quad of lanes takes it (lane t adds keys 2t, 2t+1, 8+2t, 9+2t of each
16-key block in block order in f32, then two shuffles add the four); PV as
one k16 step a block (the block's 16 products summed, rounded to f32) with
the blocks added in order in f32. The hardware's own order inside a step is
its own; what the model fixes is every sum that differs from the plain
versions' order."""

import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from card_helpers import pv_int8_limit
from team_tpu_torch.ops import mha_short as tms
from team_tpu_torch.ops.mha_short import (INV127, LOG2E, mha_packed_q3i_plain,
                                          mha_packed_q_reference)

VISION = (2, 197, 12, 64)  # batch (cut), S, heads, head width of ViT-B/16's image tower


def _split(t, heads):
    b, s, d = t.shape
    return t.reshape(b, s, heads, d // heads).permute(0, 2, 1, 3)


def _merge(t):
    b, h, s, dh = t.shape
    return t.permute(0, 2, 1, 3).reshape(b, s, h * dh)


def quad_row_sums(x):
    """``x [B, H, S, Kp]`` float32 (Kp a multiple of 16) -> each row's sum as
    the quad of lanes that holds the row takes it."""
    b, h, s, kp = x.shape
    # key 16 kb + 8 n + 2 t + j -> lane t's (kb, n, j) in the order it adds them
    lanes = x.reshape(b, h, s, kp // 16, 2, 4, 2).permute(0, 1, 2, 5, 3, 4, 6)
    lanes = lanes.reshape(b, h, s, 4, -1)
    part = torch.zeros((b, h, s, 4), dtype=torch.float32)
    for i in range(lanes.shape[-1]):
        part = part + lanes[..., i]
    pair = part + part[..., [1, 0, 3, 2]]  # shuffle xor 1
    return (pair + pair[..., [2, 3, 0, 1]])[..., :1]  # shuffle xor 2


def block_pv(p, v):
    """``p [B, H, S, Kp]`` (bf16 values) times ``v [B, H, Kp, Dh]``: each
    16-key block's sum exact, then rounded to f32; the blocks added in order."""
    b, h, s, kp = p.shape
    part = torch.einsum("bhskj,bhkjd->bhskd", p.double().reshape(b, h, s, kp // 16, 16),
                        v.double().reshape(b, h, kp // 16, 16, -1)).float()
    acc = torch.zeros((b, h, s, v.shape[-1]), dtype=torch.float32)
    for kb in range(kp // 16):
        acc = acc + part[:, :, :, kb]
    return acc


def _keep(s, kp, causal, kv_len):
    rows = torch.arange(s)[:, None]
    keys = torch.arange(kp)[None, :]
    keep = keys < min(s, kv_len or s)
    return keep & (keys <= rows) if causal else keep


def _round_int8(x):
    return torch.clamp(torch.round(x), -127, 127).to(torch.int8)


def q3i_tc_model(qkv_q, deq, qks, oinv, heads, *, causal=False, kv_len=None, qk_m2=None,
                 exp2i=False, norm="mxu"):
    """``q3i_kernel_tc``'s arithmetic in its order of summation; ``norm`` one
    of mxu, reduce, reduce_defer, pv8, pv8_defer (the kernel's enum Norm)."""
    b, s, d3 = qkv_q.shape
    d = d3 // 3
    dh = d // heads
    kp = -(-s // 16) * 16
    q, k, v = (_split(t, heads) for t in qkv_q.split(d, dim=-1))
    acc = F.pad(torch.matmul(q.double(), k.double().transpose(-1, -2)).float(), (0, kp - s))
    keep = _keep(s, kp, causal, kv_len)
    qk = qks.reshape(1, heads, 1, 1).float()
    if qk_m2 is not None:
        e = torch.exp2(acc * (qk * LOG2E) - qk_m2.reshape(1, heads, 1, 1).float())
    elif exp2i:
        m = torch.where(keep, acc, torch.tensor(-math.inf)).amax(dim=-1, keepdim=True)
        e = torch.exp2((acc - m) * (qk * LOG2E))
    else:
        logits = acc * qk
        m = torch.where(keep, logits, torch.tensor(-math.inf)).amax(dim=-1, keepdim=True)
        e = torch.exp(logits - m)
    e = torch.where(keep, e, torch.zeros(()))
    scale = (deq.reshape(-1)[2 * d:].float() * oinv.reshape(-1).float()).reshape(1, heads, 1, dh)
    vp = F.pad(v.float(), (0, 0, 0, kp - s))
    if norm == "mxu":
        pb = e.to(torch.bfloat16).float()
        out = block_pv(pb, vp) * scale / quad_row_sums(pb)
    else:
        l = quad_row_sums(e)
        p = e if norm.endswith("defer") else e / l
        if norm.startswith("pv8"):
            out = block_pv(torch.clamp(torch.round(p * 127.0), 0, 127), vp) * (scale * INV127)
        else:
            out = block_pv(p.to(torch.bfloat16).float(), vp) * scale
        if norm.endswith("defer"):
            out = out / l
    return _merge(_round_int8(out[:, :, :s]))


def packed_q_tc_model(qkv_q, deq, oinv, heads, *, causal=False, kv_len=None, bf16_deq=False):
    """``mha_q_kernel_tc``'s arithmetic (``mha_attention::WarpAttention``) in
    its order of summation."""
    b, s, d3 = qkv_q.shape
    d = d3 // 3
    dh = d // heads
    kp = -(-s // 16) * 16
    deq = deq.reshape(-1).float()
    x = qkv_q.float()
    if bf16_deq:
        q = (x[..., :d] * (deq[:d] * dh ** -0.5).to(torch.bfloat16).float()).to(torch.bfloat16)
        kv = (x[..., d:] * deq[d:].to(torch.bfloat16).float()).to(torch.bfloat16)
    else:
        q = (x[..., :d] * deq[:d] * dh ** -0.5).to(torch.bfloat16)
        kv = (x[..., d:] * deq[d:]).to(torch.bfloat16)
    q = _split(q, heads).double()
    k, v = (F.pad(_split(t, heads).double(), (0, 0, 0, kp - s)) for t in kv.split(d, dim=-1))
    logits = torch.zeros((b, heads, s, kp), dtype=torch.float32)
    for ks in range(dh // 16):  # one k16 step: its 16 products summed, then added in f32
        sl = slice(16 * ks, 16 * ks + 16)
        logits = logits + torch.matmul(q[..., sl], k[..., sl].transpose(-1, -2)).float()
    keep = _keep(s, kp, causal, kv_len)
    logits = torch.where(keep, logits, torch.tensor(-math.inf))
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = (e / quad_row_sums(e)).to(torch.bfloat16).float()
    out = _merge(block_pv(p, v.float())[:, :, :s]) * oinv.reshape(-1).float()
    return _round_int8(out)


def _q3i_inputs(b, s, heads, dh, seed=0):
    """int8 qkv and scales in the ranges of tests/test_torch_mha_q3i.py."""
    rng = np.random.default_rng(seed)
    d = heads * dh
    return [torch.from_numpy(a) for a in (
        rng.integers(-127, 128, (b, s, 3 * d)).astype(np.int8),
        rng.uniform(0.01, 0.03, (1, 3 * d)).astype(np.float32),
        (rng.uniform(1e-4, 3e-4, (1, heads)) * 4 / np.sqrt(dh)).astype(np.float32),
        rng.uniform(20, 60, (1, d)).astype(np.float32),
        rng.uniform(3, 6, (1, heads)).astype(np.float32))]


def assert_within_card_limits(got, want, limit=1):
    diff = (got.int() - want.int()).abs()
    assert got.shape == want.shape and got.dtype == want.dtype == torch.int8
    assert diff.max().item() <= limit, diff.max().item()
    assert (diff > 0).float().mean().item() < 0.01, (diff > 0).float().mean().item()


# (TEAM_QI_SOFTMAX, TEAM_QI_ROWSUM, pv_int8, defer_norm) -> the kernel's softmax and Norm
Q3I_MODES = [
    pytest.param("static", "mxu", False, False, id="static-mxu"),
    pytest.param("exp2i", "mxu", False, False, id="exp2i-mxu"),
    pytest.param("f32", "mxu", False, False, id="f32-mxu"),
    pytest.param("f32", "reduce", False, False, id="f32-reduce"),
    pytest.param("static", "reduce", False, True, id="static-reduce-defer"),
    pytest.param("static", "mxu", True, False, id="static-pv8"),
    pytest.param("exp2i", "mxu", True, True, id="exp2i-pv8-defer"),
]
# (S, causal, kv_len): the vision shape, and the masks (which take the f32 row max)
Q3I_SHAPES = [pytest.param(197, False, None, id="vision"),
              pytest.param(197, False, 150, id="kv_len"),
              pytest.param(77, True, None, id="causal")]


@pytest.mark.parametrize("s,causal,kv_len", Q3I_SHAPES)
@pytest.mark.parametrize("softmax,rowsum,pv_int8,defer", Q3I_MODES)
def test_q3i_tc_order_is_within_the_card_limits(monkeypatch, softmax, rowsum, pv_int8, defer, s,
                                                causal, kv_len):
    monkeypatch.setenv("TEAM_QI_SOFTMAX", softmax)
    monkeypatch.setenv("TEAM_QI_ROWSUM", rowsum)
    b, _, h, dh = VISION
    qkv, deq, qks, oinv, m2 = _q3i_inputs(b, s, h, dh, seed=s + int(causal))
    want = mha_packed_q3i_plain(qkv, deq, qks, oinv, h, causal=causal, kv_len=kv_len, qk_m2=m2,
                                pv_int8=pv_int8, defer_norm=defer)
    masked = causal or kv_len is not None
    norm = ("pv8" if pv_int8 else "mxu" if rowsum == "mxu" else "reduce") + \
        ("_defer" if defer and (pv_int8 or rowsum != "mxu") else "")
    got = q3i_tc_model(qkv, deq, qks, oinv, h, causal=causal, kv_len=kv_len,
                       qk_m2=m2 if softmax == "static" and not masked else None,
                       exp2i=softmax == "exp2i" and not masked, norm=norm)
    assert_within_card_limits(got, want, pv_int8_limit(deq, oinv) if pv_int8 else 1)


def test_the_q3i_model_takes_another_order():
    """The model is not the plain version itself: its f32 sums differ in the
    last bits (so the test above measures a real reordering)."""
    b, s, h, dh = VISION
    qkv, deq, qks, oinv, m2 = _q3i_inputs(b, s, h, dh)
    e = torch.rand((b, h, s, 208), generator=torch.Generator().manual_seed(0))
    assert not torch.equal(quad_row_sums(e), e.sum(dim=-1, keepdim=True))
    got = q3i_tc_model(qkv, deq, qks, oinv, h, qk_m2=m2)
    assert got.shape == (b, s, h * dh)


@pytest.mark.parametrize("s,causal,kv_len", [(197, False, None), (197, False, 150),
                                             (77, True, None), (77, True, 60)])
@pytest.mark.parametrize("bf16_deq", [False, True], ids=["q", "q3"])
def test_packed_q_tc_order_is_within_the_card_limits(bf16_deq, s, causal, kv_len):
    b, _, h, dh = VISION
    rng = np.random.default_rng(s + int(causal) + (kv_len or 0))
    d = h * dh
    qkv = torch.from_numpy(rng.integers(-127, 128, (b, s, 3 * d)).astype(np.int8))
    deq = torch.from_numpy(rng.uniform(0.01, 0.03, (1, 3 * d)).astype(np.float32))
    oinv = torch.from_numpy(rng.uniform(20, 60, (1, d)).astype(np.float32))
    want = mha_packed_q_reference(qkv, deq, oinv, h, causal, kv_len, bf16_deq)
    got = packed_q_tc_model(qkv, deq, oinv, h, causal=causal, kv_len=kv_len, bf16_deq=bf16_deq)
    assert_within_card_limits(got, want)


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("s", [197, 257])
def test_pv8_bf16_pv_is_the_int32_sum(s, dh):
    """kPv8's PV on the bf16 tensor cores: p8 in [0, 127] and v8 are exact in
    bf16, each product is exact in f32 and |sum| <= S * 127^2 < 2^24, so the
    f32 sums in block order, in reverse and key by key all equal the int32 sum
    (random values, and every p8 and |v8| at 127)."""
    assert s * 127 ** 2 < 2 ** 24
    kp = -(-s // 16) * 16
    rng = np.random.default_rng(s + dh)
    p8 = rng.integers(0, 128, (2, 3, 16, kp))
    p8[..., s:] = 0
    v8 = rng.integers(-127, 128, (2, 3, kp, dh))
    cases = [(p8, v8), (np.where(np.arange(kp) < s, 127, 0) * np.ones_like(p8),
                        np.full_like(v8, 127)), (np.full_like(p8, 127), np.full_like(v8, -127))]
    for p_i, v_i in cases:
        p, v = torch.from_numpy(p_i).float(), torch.from_numpy(v_i).float()
        assert torch.equal(p.to(torch.bfloat16).float(), p)
        assert torch.equal(v.to(torch.bfloat16).float(), v)
        exact = torch.from_numpy(np.einsum("bhsk,bhkd->bhsd", p_i.astype(np.int64),
                                           v_i.astype(np.int64))).double()
        assert torch.equal(block_pv(p, v).double(), exact)
        assert torch.equal(block_pv(p.flip(-1), v.flip(-2)).double(), exact)
        keywise = torch.zeros(exact.shape, dtype=torch.float32)
        for j in range(kp):
            keywise = keywise + p[..., j:j + 1] * v[:, :, j:j + 1, :]
        assert torch.equal(keywise.double(), exact)


# ---------------------------------------------------------------------------
# the CLS kernel (#8, #9): q3i_cls_kernel's order of summation
# ---------------------------------------------------------------------------

CLS_THREADS = 256  # threads of a CLS block (csrc/mha_packed_q3i.cu, kClsThreads)


def _xor_tree(x, lanes):
    """``x [..., lanes]`` summed as shuffle-xor steps of 1, 2, ... lanes / 2
    take it: each step adds lane i ^ o to lane i (all lanes end equal)."""
    o = 1
    while o < lanes:
        x = x + x[..., torch.arange(lanes) ^ o]
        o *= 2
    return x[..., 0]


def cls_model(qkv_q, deq, qks, oinv, heads, qk_m2=None):
    """``q3i_cls_kernel``'s arithmetic in its order of summation: p as the
    plain version forms it (q·k exact); l: thread t adds p of keys t, t +
    256, ... in order, a warp's 32 sums meet by a shuffle-xor tree, the 8
    warps' in warp order; p·v: thread (slice, word) adds p_j·v_j (exact in
    f32) for keys j = slice, slice + slices, ... in order, a warp's slices
    (32 / (dh / 4) of them) meet by a shuffle-xor tree, the warps' in warp
    order; out = rint(o · (deq_v · o_inv) / l), clipped to ±127."""
    b, s, d3 = qkv_q.shape
    d = d3 // 3
    dh = d // heads
    q, k, v = (_split(t, heads) for t in qkv_q.split(d, dim=-1))
    acc = torch.matmul(q[:, :, :1].double(), k.double().transpose(-1, -2)).float()[:, :, 0]
    qk = qks.reshape(1, heads, 1).float()
    if qk_m2 is not None:
        p = torch.exp2(acc * (qk * LOG2E) - qk_m2.reshape(1, heads, 1).float())
    else:
        logits = acc * qk
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p.to(torch.bfloat16).float()  # [B, H, S]

    sp = -(-s // CLS_THREADS) * CLS_THREADS
    by_thread = F.pad(p, (0, sp - s)).reshape(b, heads, sp // CLS_THREADS, CLS_THREADS)
    part = torch.zeros((b, heads, CLS_THREADS), dtype=torch.float32)
    for i in range(by_thread.shape[2]):
        part = part + by_thread[:, :, i]
    warps = _xor_tree(part.reshape(b, heads, CLS_THREADS // 32, 32), 32)
    l = warps[..., 0]
    for w in range(1, CLS_THREADS // 32):
        l = l + warps[..., w]

    words = dh // 4
    slices = CLS_THREADS // words
    per_warp = 32 // words
    sv = -(-s // slices) * slices
    pp = F.pad(p, (0, sv - s)).reshape(b, heads, sv // slices, slices, 1)
    vv = F.pad(v.float(), (0, 0, 0, sv - s)).reshape(b, heads, sv // slices, slices, dh)
    prod = pp * vv  # each product exact in f32: fmaf rounds once, as the add does here
    o = torch.zeros((b, heads, slices, dh), dtype=torch.float32)
    for i in range(prod.shape[2]):
        o = o + prod[:, :, i]
    o = o.reshape(b, heads, CLS_THREADS // 32, per_warp, dh).transpose(-1, -2)
    o = _xor_tree(o, per_warp)  # [B, H, warps, dh]
    out = o[:, :, 0]
    for w in range(1, CLS_THREADS // 32):
        out = out + o[:, :, w]
    scale = (deq.reshape(-1)[2 * d:].float() * oinv.reshape(-1).float()).reshape(1, heads, dh)
    out = out * scale / l[..., None]
    return _round_int8(out).reshape(b, 1, d)


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("s", [1, 7, 197, "limit"])
@pytest.mark.parametrize("softmax", ["static", "f32"])
def test_cls_order_is_within_the_card_limits(monkeypatch, softmax, s, dh):
    """The CLS kernel's order against the plain version within the card
    tests' limit (one int8 step, under 1 % of the outputs), for both
    softmaxes, up to the longest S the kernel takes."""
    monkeypatch.setenv("TEAM_QI_SOFTMAX", softmax)
    s = tms.q3i_cls_max_seq(dh) if s == "limit" else s
    b, h = (4, 3) if s > 1000 else (8, 6)
    qkv, deq, qks, oinv, m2 = _q3i_inputs(b, s, h, dh, seed=s + dh)
    want = tms.mha_packed_q3i_cls_plain(qkv, deq, qks, oinv, h, qk_m2=m2)
    got = cls_model(qkv, deq, qks, oinv, h, qk_m2=m2 if softmax == "static" else None)
    assert_within_card_limits(got, want)


def test_the_cls_model_takes_another_order():
    """The CLS model's sums are not the plain version's: its l differs from
    a sum in key order in the last bits on p spread as a softmax's are."""
    u = torch.rand((4, 12, 197), generator=torch.Generator().manual_seed(0))
    p = torch.exp2(-20 * u).to(torch.bfloat16).float()
    threads = F.pad(p, (0, CLS_THREADS - 197))
    warps = _xor_tree(threads.reshape(4, 12, 8, 32), 32)
    l = warps[..., 0]
    for w in range(1, 8):
        l = l + warps[..., w]
    in_order = torch.zeros((4, 12))
    for j in range(197):
        in_order = in_order + p[..., j]
    assert not torch.equal(l, in_order)
    assert torch.allclose(l, in_order, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dh,longest", [(32, 3402), (64, 1744), (128, 878)])
def test_the_cls_entries_take_their_longest_s_and_raise_past_it(dh, longest):
    """The longest S of the CLS entries (the kernel's shared memory, which
    the wrapper computes as the source does) runs on the CPU's plain version
    and one more raises before anything runs, from both entries."""
    assert tms.q3i_cls_max_seq(dh) == longest
    assert tms.q3i_cls_smem_bytes(longest, dh) <= 232448 < tms.q3i_cls_smem_bytes(longest + 1, dh)
    for s, ok in ((longest, True), (longest + 1, False)):
        qkv, deq, qks, oinv, m2 = _q3i_inputs(1, s, 2, dh, seed=dh)
        d = 2 * dh
        q, kv = qkv[:, :1, :d].contiguous(), qkv[:, :, d:].contiguous()
        for call in (lambda: tms.fused_mha_packed_q3i_cls(qkv, deq, qks, oinv, 2, qk_m2=m2),
                     lambda: tms.fused_mha_packed_q3i_cls_split(q, kv, deq, qks, oinv, 2,
                                                                qk_m2=m2)):
            if ok:
                assert call().shape == (1, 1, d)
            else:
                with pytest.raises(ValueError, match="shared memory"):
                    call()


def test_the_cls_limit_is_the_kernel_sources():
    """The wrapper's shared-memory formula is the source's smem_bytes_cls:
    the same thread count and the same terms."""
    text = (Path(__file__).resolve().parents[1] / "team_tpu_torch" / "csrc"
            / "mha_packed_q3i.cu").read_text()
    assert f"constexpr int kClsThreads = {CLS_THREADS};" in text
    body = text[text.index("size_t smem_bytes_cls(int seq, int dh) {"):]
    body = body[:body.index("}")]
    for term in ("2 * align16(static_cast<size_t>(seq) * dh)",
                 "align16(4 * static_cast<size_t>(seq))",
                 "static_cast<size_t>(kClsWarps) * dh * sizeof(float)",
                 "2 * kClsWarps * sizeof(float)"):
        assert term in body, term
    assert tms._Q3I_CLS_THREADS == CLS_THREADS
