"""Hold this tree's CLS attention (#8, #9), MLP megakernel (#30) and
tensor-core ceiling (#28) against another tree's, such as a parent commit
unpacked with ``git archive``, on one card: both trees' sources built here,
run on the same inputs and timed in turns (other, this, this, other); the
SASS of every kernel of every source compared over its whole listing; the
encode rates of a tree (one process per tree, so run it for each tree in
turns); and the ceiling's int8 form at #30's instruction width (m64n128k32,
64 x 256 tiles: this tree's source with that one line changed, built into
``build/``) against this tree's m64n256, in turns.

    python3 -m team_tpu_torch.scripts.parent_ab kernels <other tree>
    python3 -m team_tpu_torch.scripts.parent_ab sass <other tree>
    python3 team_tpu_torch/scripts/parent_ab.py rates <tree>
    python3 -m team_tpu_torch.scripts.parent_ab width

Needs a CUDA card and ``nvcc``; prints the card's name and power limit
first. ``kernels`` raises if the megakernels or the int8 ceilings differ in
any output bit, ``width`` if the int8 ceilings do."""

from __future__ import annotations

import ctypes
import json
import math
import os
import re
import subprocess
import sys
import time

SOURCES_AB = ("mha_packed_q3i.cu", "gemm_probe.cu")
ANON = re.compile(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")


def _card() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


def _build_other(other: str, sources, out_dir: str) -> dict:
    """nvcc of the other tree's sources (this tree's flags), in parallel."""
    from team_tpu_torch.ops import _build

    os.makedirs(out_dir, exist_ok=True)
    jobs = {s: subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                                 os.path.join(out_dir, s.replace(".cu", ".so")),
                                 os.path.join(other, "team_tpu_torch", "csrc", s)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s in sources}
    for s, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the other tree's {s}:\n{log}")
    return {s: os.path.join(out_dir, s.replace(".cu", ".so")) for s in sources}


def kernels(other: str) -> None:
    import torch

    import chip_smoke as cs
    from team_tpu_torch.ops import gemm_probe as gp
    from team_tpu_torch.ops import mha_short as ms
    from team_tpu_torch.scripts import int8_mxu_ceiling as mc
    from team_tpu_torch.scripts import r5_megakernel_probe as r5

    _card()
    libs = {s: ctypes.CDLL(p) for s, p in
            _build_other(other, SOURCES_AB, os.path.join("build", "ab_other")).items()}
    dev = torch.device("cuda", 0)
    p = [ctypes.c_void_p]
    q3i = libs["mha_packed_q3i.cu"]
    q3i.team_mha_packed_q3i_cls_fwd.argtypes = p * 6 + [ctypes.c_int] * 4 + p
    q3i.team_mha_packed_q3i_cls_split_fwd.argtypes = p * 7 + [ctypes.c_int] * 4 + p

    def other_cls(split, *ins, vecs, h, b, d):
        out = torch.empty((b, 1, d), dtype=torch.int8, device=dev)
        fn = q3i.team_mha_packed_q3i_cls_split_fwd if split else q3i.team_mha_packed_q3i_cls_fwd
        err = fn(*(t.data_ptr() for t in ins), *(t.data_ptr() for t in vecs), out.data_ptr(), b,
                 ins[-1].shape[1], h, d // h, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the other tree's CLS entry: error {err}")
        return out

    b, s, h = 128, 197, 12
    d = 64 * h
    qkv, deq, qks, oinv, m2 = cs.q3i_inputs(b, s, h, dev, seed=2)
    vecs = [t.reshape(-1).float().contiguous() for t in (deq, qks, oinv, m2)]
    qq, kv = qkv[:, :1, :d].contiguous(), qkv[:, :, d:].contiguous()
    pairs = {"q3i_cls": (lambda: ms.fused_mha_packed_q3i_cls(qkv, deq, qks, oinv, h, qk_m2=m2),
                         lambda: other_cls(False, qkv, vecs=vecs, h=h, b=b, d=d)),
             "q3i_cls_split": (lambda: ms.fused_mha_packed_q3i_cls_split(qq, kv, deq, qks, oinv, h,
                                                                         qk_m2=m2),
                               lambda: other_cls(True, qq, kv, vecs=vecs, h=h, b=b, d=d))}

    mega = libs["gemm_probe.cu"]
    parks = hasattr(mega, "team_mlp_mega_park_bytes")
    mega.team_mlp_mega.argtypes = p * (8 if parks else 7) + [ctypes.c_int] * 3 + p
    if parks:
        mega.team_mlp_mega_park_bytes.argtypes = [ctypes.c_int] * 3
        mega.team_mlp_mega_park_bytes.restype = ctypes.c_longlong
    params, inputs = r5.make_inputs(r5.B, 1, dev)
    x2 = inputs[0].reshape(-1, inputs[0].shape[-1])
    m, k = x2.shape
    n = params[0].shape[1]
    vec = [gp._aligned(t.reshape(-1).float()) for t in (params[1], params[4], params[3])]
    w1t, w2t = gp._aligned(params[0].t()), gp._aligned(params[2].t())
    park = (torch.empty((max(mega.team_mlp_mega_park_bytes(m, k, n), 4) // 4,), dtype=torch.int32,
                        device=dev),) if parks else ()

    def other_mega():
        out = torch.empty((m, k), dtype=torch.bfloat16, device=dev)
        err = mega.team_mlp_mega(x2.data_ptr(), w1t.data_ptr(), vec[0].data_ptr(),
                                 vec[1].data_ptr(), w2t.data_ptr(), vec[2].data_ptr(),
                                 out.data_ptr(), *(t.data_ptr() for t in park), m, k, n,
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the other tree's megakernel: error {err}")
        return out

    pairs["mlp_mega"] = (lambda: gp.mlp_mega_2d(x2, *params), other_mega)
    for dtype in (torch.int8, torch.bfloat16):
        x, w = mc.make_inputs(dtype, mc.M, mc.K, dev)
        # the other tree's grid by its own rule: the mma.sync ceiling's
        # (64-row tiles of team_mxu_ceiling_block_n columns, groups a power of
        # two under 64 until the CTAs fill the SMs twice), else this tree's
        groups = _other_groups(mega, x, w, mc.M)
        pairs[f"mxu_ceiling {'int8' if dtype == torch.int8 else 'bf16'}"] = (
            lambda x=x, w=w: gp.mxu_ceiling(x, w, mc.REPS, mc.M),
            lambda x=x, w=w, g=groups: _ceiling_call(mega, x, w, mc.REPS, mc.M, g))
    for name, (this, that) in pairs.items():
        a, o = this(), that()
        torch.cuda.synchronize()
        diff = (a.float() - o.float()).abs()
        print(f"  {name}: this tree vs the other: max |diff| {diff.max().item():.3e}, "
              f"{int((diff > 0).sum())} outputs differ", flush=True)
        if name in ("mlp_mega", "mxu_ceiling int8") and not torch.equal(a, o):
            raise AssertionError(f"the two trees' {name} differ")
        iters = 10 if name.startswith(("mlp_mega", "mxu_ceiling")) else 50
        for _ in range(2):
            t1, k1, k2, t2 = (cs._time_ms(fn, iters) for fn in (that, this, this, that))
            print(f"  time {name}: other {t1:.4f}/{t2:.4f} ms, this {k1:.4f}/{k2:.4f} ms",
                  flush=True)


def _ceiling_call(lib, x, w, reps: int, m: int, groups: int):
    """team_mxu_ceiling of a library (this tree's or another's; both take the
    same arguments) on the probe's operands, with its own groups."""
    import torch

    from team_tpu_torch.ops import gemm_probe as gp

    lib.team_mxu_ceiling.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    k, n = w.shape
    xa, wt = gp._aligned(x), gp._aligned(w.t())
    part = torch.empty((groups, m, n), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    err = lib.team_mxu_ceiling(xa.data_ptr(), wt.data_ptr(), part.data_ptr(), out.data_ptr(), m, n,
                               k, reps, groups, int(x.dtype == torch.bfloat16),
                               torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"team_mxu_ceiling: error {err}")
    return out


def _sms(x) -> int:
    import torch

    return torch.cuda.get_device_properties(x.device).multi_processor_count


def _other_groups(lib, x, w, m: int) -> int:
    import torch

    from team_tpu_torch.ops import gemm_probe as gp

    n = w.shape[1]
    if not hasattr(lib, "team_mxu_ceiling_block_n"):
        return gp.ceiling_groups(gp.ceiling_tiles(m, n), _sms(x))
    lib.team_mxu_ceiling_block_n.argtypes = [ctypes.c_int]
    bn = lib.team_mxu_ceiling_block_n(int(x.dtype == torch.bfloat16))
    tiles = math.ceil(m / 64) * math.ceil(n / bn)
    groups = 1
    while groups < 64 and tiles * groups < 2 * _sms(x):
        groups *= 2
    return groups


# the line of csrc/gemm_probe.cu that sets the ceiling's int8 tiles, and its
# form at #30's instruction width
CEILING_S8 = "using CeilingS8 = wg::Config<128, 256, 4, 1>;"
CEILING_S8_N128 = "using CeilingS8 = wg::Config<64, 256, 4, 1, 128>;"


def width() -> None:
    """The ceiling's int8 form on m64n256k32 (this tree) and on m64n128k32
    in 64 x 256 tiles (#30's instruction and tile), each on its own grid
    (tiles x max(1, SMs / tiles) CTAs), timed in turns; both bit for bit."""
    import torch

    import chip_smoke as cs
    from team_tpu_torch.ops import _build
    from team_tpu_torch.ops import gemm_probe as gp
    from team_tpu_torch.scripts import int8_mxu_ceiling as mc

    _card()
    src = (_build.CSRC_DIR / "gemm_probe.cu").read_text()
    if src.count(CEILING_S8) != 1:
        raise RuntimeError(f"csrc/gemm_probe.cu does not set the int8 ceiling by {CEILING_S8!r}")
    out_dir = os.path.join("build", "ab_n128")
    os.makedirs(out_dir, exist_ok=True)
    patched, lib_path = os.path.join(out_dir, "gemm_probe.cu"), os.path.join(out_dir, "gemm_probe.so")
    with open(patched, "w") as f:
        f.write(src.replace(CEILING_S8, CEILING_S8_N128))
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o",
                           lib_path, patched], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the m64n128 ceiling:\n{proc.stdout}{proc.stderr}")
    print("  ptxas, the m64n128 ceiling: " + "; ".join(
        ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
        if "ceiling_kernel_wg" in ln or "registers" in ln or "spill" in ln or "C75" in ln))
    n128 = ctypes.CDLL(os.path.abspath(lib_path))
    dev = torch.device("cuda", 0)
    x, w = mc.make_inputs(torch.int8, mc.M, mc.K, dev)
    tiles = math.ceil(mc.M / 64) * math.ceil(mc.K / 256)
    groups = gp.ceiling_groups(tiles, _sms(x))
    this = lambda: gp.mxu_ceiling(x, w, mc.REPS, mc.M)  # noqa: E731
    that = lambda: _ceiling_call(n128, x, w, mc.REPS, mc.M, groups)  # noqa: E731
    if not torch.equal(this(), that()):
        raise AssertionError("the m64n128 ceiling differs from the m64n256 one")
    ops = 2 * mc.M * mc.K * mc.K * mc.REPS
    wide = gp.ceiling_tiles(mc.M, mc.K)
    ctas = {"m64n256": wide * gp.ceiling_groups(wide, _sms(x)), "m64n128": tiles * groups}
    print(f"  int8 M={mc.M} K=N={mc.K} REPS={mc.REPS}: bit for bit; CTAs {ctas} of {_sms(x)} SMs",
          flush=True)
    for _ in range(2):
        t1, k1, k2, t2 = (cs._time_ms(fn, 10) for fn in (that, this, this, that))
        print(f"  time: m64n128 {t1:.4f}/{t2:.4f} ms ({2 * ops / (t1 + t2) / 1e9:.1f} TOP/s, "
              f"{2 * ops / (t1 + t2) / 1e9 * _sms(x) / ctas['m64n128']:.1f} a full card of such "
              f"CTAs), m64n256 {k1:.4f}/{k2:.4f} ms ({2 * ops / (k1 + k2) / 1e9:.1f} TOP/s)",
              flush=True)


def _sass(cuobjdump: str, lib: str) -> dict:
    listing = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                             check=True).stdout
    out, name = {}, None
    for line in listing.splitlines():
        if "Function :" in line:
            name = ANON.sub("ANON", line.split("Function :")[1].strip())
            out[name] = []
        elif name is not None and line.strip():
            # cuobjdump pads its columns to the listing's longest line
            out[name].append(ANON.sub("ANON", " ".join(line.split())))
    return out


def sass(other: str) -> None:
    from team_tpu_torch.ops import _build

    sources = sorted(f for f in os.listdir(_build.CSRC_DIR) if f.endswith(".cu"))
    built = _build_other(other, sources, os.path.join("build", "ab_other"))
    _build._compile(sources)
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    same = 0
    for src in sources:
        this, that = _sass(cuobjdump, str(_build._target(src))), _sass(cuobjdump, built[src])
        equal = [f for f in this if that.get(f) == this[f]]
        same += len(equal)
        print(f"{src}: {len(equal)} kernels identical to the other tree's; differ "
              f"{[f for f in this if f in that and f not in equal]}; this tree only "
              f"{[f for f in this if f not in that]}; the other only "
              f"{[f for f in that if f not in this]}", flush=True)
    print(f"identical kernels in all: {same}")


def rates(tree: str) -> None:
    """Encode rates of the tree at ``tree`` (this process imports its code)."""
    sys.path.insert(0, os.path.abspath(tree))
    os.chdir(tree)
    import torch

    from team_tpu_torch.backbone import clip as tclip
    from team_tpu_torch.backbone import quant as tquant
    from team_tpu_torch.bridge import tree_to

    dev = torch.device("cuda", 0)
    cfg = tclip.CLIPConfig.vit_b16()
    params = tclip.init_clip_params(torch.Generator().manual_seed(0), cfg)
    p32 = tree_to(params, dev)
    u8 = torch.randint(0, 256, (128, 224, 224, 3), generator=torch.Generator(device=dev)
                       .manual_seed(1), device=dev, dtype=torch.uint8)
    mean = torch.tensor([0.48145466, 0.4578275, 0.40821073], device=dev)
    std = torch.tensor([0.26862954, 0.26130258, 0.27577711], device=dev)
    x = (u8.float() / 255 - mean) / std
    qs = tquant.quantize_vision_tower_static(p32, tquant.calibrate_vision_tower(p32, x[:16], cfg),
                                             heads=cfg.vision.heads)
    qd = tquant.quantize_vision_tower(p32)
    pbf = tclip.cast_frozen_params(params, torch.bfloat16, dev)

    def rate(fn, n=10):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return n * 128 / (time.perf_counter() - t0)

    routes = {r: (lambda r=r: tquant.encode_image_int8_u8(qs, u8, cfg, gemm_impl=r))
              for r in ("static3d_qi", "static_qa", "static", "static3d", "static3d_qa",
                        "static3d_qaf", "static3d_qis")}
    routes["kqs"] = lambda: tquant.encode_image_int8_u8(qs, u8, cfg, cls_last="kqs")
    for tier in ("hybrid", "pallas"):
        routes[tier] = lambda t=tier: tquant.encode_image_int8_u8(qd, u8, cfg, gemm_impl=t)
    routes["bf16"] = lambda: tclip.encode_image(pbf, x.to(torch.bfloat16), cfg,
                                                compute_dtype=torch.bfloat16)
    # the median of three rates of ten encodes each, B=128
    print(json.dumps({"tree": tree, "img_per_s": {name: sorted(rate(fn) for _ in range(3))[1]
                                                  for name, fn in routes.items()}}), flush=True)


if __name__ == "__main__":
    cmd, args = sys.argv[1], sys.argv[2:]
    if cmd == "rates":
        rates(*args)
    else:
        sys.path.insert(0, os.getcwd())  # chip_smoke, from the repository root
        {"kernels": kernels, "sass": sass, "width": width}[cmd](*args)
