"""The GEMM probes' kernels: a large square product, the tensor cores'
ceiling, and the int8 MLP megakernel.

Counterparts of the TPU kernels of the repository's probe scripts, driven by
``team_tpu_torch/scripts/{int8_probe,int8_mxu_ceiling,r5_megakernel_probe}.py``:
- ``probe_mm`` (``scripts/int8_probe.py:48 pallas_mm``): ``x @ w``, int8 ->
  int32 exact or bf16 -> float32;
- ``mxu_ceiling`` (``scripts/int8_mxu_ceiling.py:50 run``, kernel
  ``_kernel_windows``): the sum of ``reps`` products of sliding windows of x
  with w, every product issued on the tensor cores;
- ``mlp_mega_2d`` / ``mlp_mega_3d`` (``scripts/r5_megakernel_probe.py:73``,
  ``:105``, kernel ``_mlp_mega_kernel``): fc -> tanh GELU -> static int8
  requantize -> proj in one kernel, the int8 intermediate kept on chip.

One CUDA source, ``csrc/gemm_probe.cu``, compiled with ``nvcc`` on first use
and bound with ``ctypes``: all three on ``wgmma`` fed by TMA
(``csrc/wgmma_gemm.cuh``; the megakernel keeps hq in shared memory a slab of
1,536 columns at a time, streams the weights through a ring of its own and
parks its proj sums between the slabs in device memory that the wrapper
allocates; the ceiling runs each window's products back to back from one
staged pair of boxes, so it measures the ``wgmma`` ceiling of the card). On a
CPU tensor each wrapper
computes its plain version (the ``*_reference`` function beside it); on a
CUDA tensor it launches its kernel or raises, and adds one to its
``launches``. The TPU tiling arguments (``block_m``, ``block_b``,
``interpret``) are accepted and change nothing.

The kernels take the weight operands as their transposes, row-major; a
column-major ``[K, N]`` weight is that transpose as a view (``column_major``
lays one out), any other layout is copied at each call. The probes lay their
weights out once, before anything is timed.

Tolerances against the plain versions (held by the tests and ``chip_smoke.py``):
- ``probe_mm`` int8 and ``mxu_ceiling`` int8: bit for bit (int32 sums are
  exact; the ceiling's output is f32 of the exact int32 sum);
- ``probe_mm`` bf16: :func:`probe_mm_bf16_limit`; ``mxu_ceiling`` bf16:
  :data:`CEILING_BF16_SHARE` of the largest |ref|;
- ``mlp_mega``: :func:`mlp_mega_limit`, bit for bit on every row where no
  requantized value lies near a rounding edge.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from team_tpu_torch.ops._grad import refuse_grad
from team_tpu_torch.ops.int8_matmul import _aligned, _raise_on, column_major, int8_matmul

_SOURCE = "gemm_probe.cu"
WINDOWS = 64  # the ceiling's distinct windows: x rows from 8·j, j < 64
WINDOW_STRIDE = 8
# mxu_ceiling bf16 against its plain version: this share of the largest |ref|.
# A CTA sums its range of 181-182 products in one f32 accumulator (some 8,700
# k16 steps at the probe's shape, magnitudes under 2^7), then the 11 groups'
# partials are added in order; the tests model that order in f32, rounding to
# nearest and toward zero, at a small size (on an H100 the probe's worst
# output is 0.056 off, a fifth of the limit). A product missing or a window out
# of place moves an output by one window product, 0.28 rms at the probe's
# inputs, where this share is 0.27: past the limit on about a third of them.
CEILING_BF16_SHARE = 2.0 ** -10
# rows and columns of a ceiling CTA's output tile (csrc/gemm_probe.cu)
CEILING_TILE = (128, 256)
# mlp_mega: ulps of tanh that the libraries (CUDA's tanhf, torch's, XLA's) and
# the few-ulp differences of its argument may move it by
TANH_ULPS = 16


def _library() -> ctypes.CDLL:
    from team_tpu_torch.ops._build import load_library

    lib = load_library(_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.team_probe_mm.argtypes = [p] * 3 + [i] * 4 + [p]
    lib.team_mxu_ceiling.argtypes = [p] * 4 + [i] * 6 + [p]
    lib.team_mlp_mega.argtypes = [p] * 8 + [i] * 3 + [p]
    lib.team_mlp_mega_park_bytes.argtypes = [i] * 3
    lib.team_mlp_mega_park_bytes.restype = ctypes.c_longlong
    for fn in (lib.team_probe_mm, lib.team_mxu_ceiling, lib.team_mlp_mega,
               lib.team_mlp_mega_max_n):
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load this module's kernels now (set-up)."""
    _library()


def _on_card(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {dev}")
    refuse_grad(name, *tensors)
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{name}: operands lie on {t.device} and {dev}")


def ulp32(v: torch.Tensor) -> torch.Tensor:
    """One float32 ulp at each ``|v|`` (at least that of the smallest normal)."""
    _, e = torch.frexp(v.abs().float().clamp_min(2.0 ** -126))  # |v| = m 2^e, m in [0.5, 1)
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 24)


def bf16_step(v: torch.Tensor) -> torch.Tensor:
    """One bfloat16 step (unit in the last place) at each ``|v|``."""
    _, e = torch.frexp(v.abs().float().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


# ---------------------------------------------------------------------------
# probe_mm (scripts/int8_probe.py:48 pallas_mm)
# ---------------------------------------------------------------------------

_MM_TYPES = {torch.int8: torch.int32, torch.bfloat16: torch.float32}


def _mm_types(name: str, x: torch.Tensor, w: torch.Tensor, acc_dtype: Optional[torch.dtype]):
    if x.dtype not in _MM_TYPES or w.dtype != x.dtype:
        raise TypeError(f"{name} takes int8 or bfloat16 operands of one type, got {x.dtype} "
                        f"and {w.dtype}")
    want = _MM_TYPES[x.dtype]
    if acc_dtype is not None and acc_dtype != want:
        raise TypeError(f"{name}: {x.dtype} accumulates in {want}, not {acc_dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: x [M, K] and w [K, N] must share K, got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    return want


def probe_mm_reference(x: torch.Tensor, w: torch.Tensor,
                       acc_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version of ``_mm_kernel``: ``x @ w`` in float64, then
    int32 (int8 operands: exact while K·127² < 2^53) or float32 (bf16
    operands: the exact sum rounded once)."""
    want = _mm_types("probe_mm", x, w, acc_dtype)
    return torch.matmul(x.double(), w.double()).to(want)


def probe_mm_bf16_limit(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The largest |kernel − plain| each bf16 output may show: (K/16 + 1)
    ulps of ``|x| @ |w|``. Each product is exact in f32; the kernel adds K/16
    mma steps of 16 products into an f32 accumulator, each rounding at most
    one ulp of a partial sum no larger than ``|x| @ |w|``. (On the probe's
    int8-valued inputs every partial sum below 2^24 is an exact integer.)"""
    k = x.shape[1]
    s_abs = torch.matmul(x.double().abs(), w.double().abs()).float()
    return (k // 16 + 1) * ulp32(s_abs)


def _probe_mm_kernel(name: str, x: torch.Tensor, w: torch.Tensor,
                     want: torch.dtype) -> torch.Tensor:
    """Launch ``probe_mm``'s kernel on checked CUDA operands."""
    _on_card(name, x, w)
    bf16 = int(x.dtype == torch.bfloat16)
    m, k = x.shape
    n = w.shape[1]
    if k % (16 if bf16 else 32) or n % 8:
        raise ValueError(f"{name}: the kernel takes K divisible by {16 if bf16 else 32} and N by "
                         f"8 (the mma shape), got K={k}, N={n}")
    x, wt = _aligned(x), _aligned(w.t())
    out = torch.empty((m, n), dtype=want, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.team_probe_mm(x.data_ptr(), wt.data_ptr(), out.data_ptr(), m, n, k, bf16,
                                torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    return out


def probe_mm(x: torch.Tensor, w: torch.Tensor, acc_dtype: Optional[torch.dtype] = None, *,
             block_m: int = 512, block_n: int = 512, block_k: int = 1024) -> torch.Tensor:
    """``x [M, K] @ w [K, N]``: int8 -> int32 (exact), or bf16 -> float32
    (``scripts/int8_probe.py:48``); ``acc_dtype``, where given, must name that
    type. On the card the ``wgmma`` kernel, K a multiple of 32 (int8) or 16
    (bf16) and N of 8. Each kernel launch adds one to ``probe_mm.launches``."""
    want = _mm_types("probe_mm", x, w, acc_dtype)
    if x.device.type == "cpu":
        return probe_mm_reference(x, w, acc_dtype)
    out = _probe_mm_kernel("probe_mm", x, w, want)
    probe_mm.launches += 1
    return out


# ---------------------------------------------------------------------------
# mxu_ceiling (scripts/int8_mxu_ceiling.py:50 run)
# ---------------------------------------------------------------------------

def window_counts(reps: int) -> list:
    """How many of the ``reps`` products use window j: i < reps with i mod 64 == j."""
    return [reps // WINDOWS + (j < reps % WINDOWS) for j in range(WINDOWS)]


def _ceiling_check(name: str, x: torch.Tensor, w: torch.Tensor, reps: int, m: int) -> None:
    if x.dtype not in _MM_TYPES or w.dtype != x.dtype:
        raise TypeError(f"{name} takes int8 or bfloat16 operands of one type, got {x.dtype} "
                        f"and {w.dtype}")
    need = m + WINDOW_STRIDE * (WINDOWS - 1)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: x [rows, K] and w [K, N] must share K, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if m <= 0 or reps < 0 or x.shape[0] < need:
        raise ValueError(f"{name}: windows of m={m} rows at 8·j, j < 64, need x of at least "
                         f"{need} rows and reps >= 0, got {x.shape[0]} rows, reps={reps}")


def mxu_ceiling_reference(x: torch.Tensor, w: torch.Tensor, reps: int = 2000,
                          m: int = 512) -> torch.Tensor:
    """Plain PyTorch version of ``_kernel_windows``: ``Σ_{i<reps} x[8(i mod
    64) : 8(i mod 64) + m] @ w`` as ``(Σ_j count_j · x_j) @ w`` in float64,
    then float32. Exact for the probe's int8 inputs (sums under 2^53)."""
    _ceiling_check("mxu_ceiling", x, w, reps, m)
    y = torch.zeros((m, x.shape[1]), dtype=torch.float64, device=x.device)
    for j, count in enumerate(window_counts(reps)):
        if count:
            y += count * x[WINDOW_STRIDE * j:WINDOW_STRIDE * j + m].double()
    return torch.matmul(y, w.double()).float()


def ceiling_tiles(m: int, n: int) -> int:
    """The ceiling's output tiles of ``CEILING_TILE`` over ``[m, n]``."""
    return math.ceil(m / CEILING_TILE[0]) * math.ceil(n / CEILING_TILE[1])


def ceiling_groups(tiles: int, sms: int) -> int:
    """The ranges the products are cut into: as many as leave one CTA (a tile
    and a range) an SM in one wave, at least one."""
    return max(1, sms // tiles)


def ceiling_split(reps: int, groups: int) -> list:
    """What each group's CTAs compute, as the kernel cuts it: the ``reps``
    products laid out window-major (window j's ``window_counts`` together),
    group g taking ``[g·reps // groups, (g + 1)·reps // groups)``; for each
    group its ``(window, products)`` in order."""
    starts = [0]
    for count in window_counts(reps):
        starts.append(starts[-1] + count)
    split = []
    for g in range(groups):
        lo, hi = g * reps // groups, (g + 1) * reps // groups
        split.append([(j, min(starts[j + 1], hi) - max(starts[j], lo)) for j in range(WINDOWS)
                      if min(starts[j + 1], hi) > max(starts[j], lo)])
    return split


def mxu_ceiling(x: torch.Tensor, w: torch.Tensor, reps: int = 2000, m: int = 512) -> torch.Tensor:
    """``out [m, N] float32 = Σ_{i<reps} x[8(i mod 64) : 8(i mod 64) + m] @
    w`` (``scripts/int8_mxu_ceiling.py:50``): int8 operands accumulate in
    int32, bf16 in float32. x holds at least ``m + 504`` rows. Every product
    is computed; its rate is ``2·m·K·N·reps`` over the time. On the card K is
    a multiple of 32 (int8) or 16 (bf16) and N of 8; the products are cut
    into ``ceiling_groups`` ranges for the card's SMs. Each kernel launch
    adds one to ``mxu_ceiling.launches``."""
    name = "mxu_ceiling"
    if x.device.type == "cpu":
        return mxu_ceiling_reference(x, w, reps, m)
    _ceiling_check(name, x, w, reps, m)
    _on_card(name, x, w)
    bf16 = int(x.dtype == torch.bfloat16)
    k, n = w.shape
    if k % (16 if bf16 else 32) or n % 8:
        raise ValueError(f"{name}: the kernel takes K divisible by {16 if bf16 else 32} and N by "
                         f"8, got K={k}, N={n}")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    groups = ceiling_groups(ceiling_tiles(m, n), sms)
    lib = _library()
    x, wt = _aligned(x), _aligned(w.t())
    part = torch.empty((groups, m, n), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.team_mxu_ceiling(x.data_ptr(), wt.data_ptr(), part.data_ptr(), out.data_ptr(),
                                   m, n, k, reps, groups, bf16,
                                   torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    mxu_ceiling.launches += 1
    return out


# ---------------------------------------------------------------------------
# mlp_mega (scripts/r5_megakernel_probe.py:73/105)
# ---------------------------------------------------------------------------

GELU_C = 0.7978845608028654  # float32(sqrt(2/pi)), the script's constant


def _gelu_tanh_parts(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The script's ``_gelu_tanh`` in its order, ``0.5·a·(1 + tanh(c·(a +
    ((0.044715·a)·a)·a)))``, each operation rounded to float32: (tanh, gelu)."""
    inner = GELU_C * (a + 0.044715 * a * a * a)
    t = torch.tanh(inner)
    return t, (0.5 * a) * (1.0 + t)


def _mega_operands(name: str, x_q, w1, s1, w2, s2, qi):
    if any(t.dtype != torch.int8 for t in (x_q, w1, w2)):
        raise TypeError(f"{name} takes int8 x, w1 and w2, got {x_q.dtype}, {w1.dtype}, "
                        f"{w2.dtype}")
    k = x_q.shape[-1]
    if w1.dim() != 2 or w1.shape[0] != k or w2.dim() != 2 or tuple(w2.shape) != (w1.shape[1], k):
        raise ValueError(f"{name}: x [..., K], w1 [K, N] and w2 [N, K] disagree: "
                         f"{tuple(x_q.shape)}, {tuple(w1.shape)}, {tuple(w2.shape)}")
    n = w1.shape[1]
    for vname, t, size in (("s1", s1, n), ("qi", qi, n), ("s2", s2, k)):
        if t.numel() != size:
            raise ValueError(f"{name}: {vname} must hold {size} values, got {tuple(t.shape)}")
    return k, n


def mlp_mega_hidden(x_q: torch.Tensor, w1: torch.Tensor, s1: torch.Tensor,
                    qi: torch.Tensor) -> dict:
    """The plain version's float steps before the requantize, on ``[M, N]``:
    ``a = f32(x @ w1)·s1``, ``t`` its tanh, ``h = gelu(a)`` and ``v = h·qi``
    (the value ``rint`` rounds)."""
    x2 = x_q.reshape(-1, x_q.shape[-1])
    a = int8_matmul(x2, w1).float() * s1.reshape(1, -1).float()
    t, h = _gelu_tanh_parts(a)
    return {"a": a, "t": t, "h": h, "v": h * qi.reshape(1, -1).float()}


def mlp_mega_reference(x_q: torch.Tensor, w1: torch.Tensor, s1: torch.Tensor, w2: torch.Tensor,
                       s2: torch.Tensor, qi: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``_mlp_mega_kernel`` on ``x_q [..., K]``:
    ``hq = clip(rint(gelu_tanh(f32(x @ w1)·s1)·qi), ±127)`` int8 (the script's
    GELU order), then ``bf16(f32(hq @ w2)·s2)``; the products exact in int32."""
    _mega_operands("mlp_mega", x_q, w1, s1, w2, s2, qi)
    v = mlp_mega_hidden(x_q, w1, s1, qi)["v"]
    hq = torch.clamp(torch.round(v), -127, 127).to(torch.int8)
    y = int8_matmul(hq, w2).float() * s2.reshape(1, -1).float()
    return y.to(torch.bfloat16).reshape(x_q.shape)


def mlp_mega_edge_rows(x_q: torch.Tensor, w1: torch.Tensor, s1: torch.Tensor,
                       qi: torch.Tensor) -> torch.Tensor:
    """For each row, how many ``v = h·qi`` lie so near a rounding edge
    (``.5``, below 127.5, where ``rint`` and the clip give two int8 values)
    that another library's tanh could put them across it: within ``qi·(|a/2|
    · TANH_ULPS ulps of |t| + 4 ulps of |h|) + 2 ulps of |v|``. Only there
    may a kernel's hq differ from the plain version's."""
    p = mlp_mega_hidden(x_q, w1, s1, qi)
    qv = qi.reshape(1, -1).float().abs()
    slack = qv * ((0.5 * p["a"]).abs() * TANH_ULPS * ulp32(p["t"]) + 4 * ulp32(p["h"])) \
        + 2 * ulp32(p["v"])
    av = p["v"].abs()
    edge = torch.floor(av) + 0.5
    near = ((av - edge).abs() <= slack) & (edge < 127.5)
    return near.sum(dim=1)


def mlp_mega_limit(ref: torch.Tensor, edges: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """The largest |kernel − plain| each output may show: a row with F
    near-edge values (:func:`mlp_mega_edge_rows`) may have F hq flipped by
    one, each moving its outputs by at most 127·|s2|, plus one bf16 step of
    the moved value; a row with none must agree bit for bit."""
    r = ref.float().reshape(edges.shape[0], -1)
    f = edges.reshape(-1, 1).float()
    moved = f * 127.0 * s2.float().abs().max()
    return (moved + torch.where(f > 0, bf16_step(r.abs() + moved), torch.zeros_like(r))
            ).reshape(ref.shape)


def _mlp_mega_kernel(name: str, x2: torch.Tensor, w1, s1, w2, s2, qi) -> torch.Tensor:
    _on_card(name, x2, w1, s1, w2, s2, qi)
    m, k = x2.shape
    n = w1.shape[1]
    lib = _library()
    if k % 32 or n % 32 or n > lib.team_mlp_mega_max_n():
        raise ValueError(f"{name}: the kernel takes K and N divisible by 32 and N at most "
                         f"{lib.team_mlp_mega_max_n()}, got K={k}, N={n}")
    vec = [_aligned(t.reshape(-1).float()) for t in (s1, qi, s2)]
    x2, w1t, w2t = _aligned(x2), _aligned(w1.t()), _aligned(w2.t())
    out = torch.empty((m, k), dtype=torch.bfloat16, device=x2.device)
    with torch.cuda.device(x2.device):
        # the kernel parks its proj sums between the two slabs of hq here
        park_bytes = lib.team_mlp_mega_park_bytes(m, k, n)
        if park_bytes < 0:
            raise RuntimeError(f"{name}: team_mlp_mega_park_bytes failed")
        park = torch.empty((park_bytes // 4,), dtype=torch.int32, device=x2.device) \
            if park_bytes else None
        err = lib.team_mlp_mega(x2.data_ptr(), w1t.data_ptr(), vec[0].data_ptr(),
                                vec[1].data_ptr(), w2t.data_ptr(), vec[2].data_ptr(),
                                out.data_ptr(), None if park is None else park.data_ptr(), m, k,
                                n, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    return out


def mlp_mega_2d(x_q: torch.Tensor, w1: torch.Tensor, s1: torch.Tensor, w2: torch.Tensor,
                s2: torch.Tensor, qi: torch.Tensor, *, block_m: int = 512,
                interpret: bool = False) -> torch.Tensor:
    """``[M, K]`` int8 -> ``[M, K]`` bf16, the whole MLP in one kernel
    (``scripts/r5_megakernel_probe.py:73``): w1 ``[K, N]``, w2 ``[N, K]``
    int8, s1 and qi ``[1, N]``, s2 ``[1, K]`` float32. Each kernel launch adds
    one to ``mlp_mega_2d.launches``."""
    name = "mlp_mega_2d"
    if x_q.dim() != 2:
        raise ValueError(f"{name}: x must be [M, K], got {tuple(x_q.shape)}")
    _mega_operands(name, x_q, w1, s1, w2, s2, qi)
    if x_q.device.type == "cpu":
        return mlp_mega_reference(x_q, w1, s1, w2, s2, qi)
    out = _mlp_mega_kernel(name, x_q, w1, s1, w2, s2, qi)
    mlp_mega_2d.launches += 1
    return out


def mlp_mega_3d(x_q: torch.Tensor, w1: torch.Tensor, s1: torch.Tensor, w2: torch.Tensor,
                s2: torch.Tensor, qi: torch.Tensor, *, block_b: int = 8,
                interpret: bool = False) -> torch.Tensor:
    """``[B, S, K]`` int8 -> ``[B, S, K]`` bf16 (``scripts/r5_megakernel_probe.py:105``):
    the 2-D kernel on the ``[B·S, K]`` view, bit for bit :func:`mlp_mega_2d`.
    Each kernel launch adds one to ``mlp_mega_3d.launches``."""
    name = "mlp_mega_3d"
    if x_q.dim() != 3:
        raise ValueError(f"{name}: x must be [B, S, K], got {tuple(x_q.shape)}")
    _mega_operands(name, x_q, w1, s1, w2, s2, qi)
    if x_q.device.type == "cpu":
        return mlp_mega_reference(x_q, w1, s1, w2, s2, qi)
    b, s, k = x_q.shape
    out = _mlp_mega_kernel(name, x_q.reshape(b * s, k), w1, s1, w2, s2, qi)
    mlp_mega_3d.launches += 1
    return out.reshape(b, s, k)


_COUNTED = (probe_mm, mxu_ceiling, mlp_mega_2d, mlp_mega_3d)


def reset_launch_counts() -> None:
    for fn in _COUNTED:
        fn.launches = 0


reset_launch_counts()
