"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 teambench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``python3 -m teambench.run`` works too), on a
machine with as many CUDA cards as the cell asks for. It exits with a code
other than 0 and prints no result where the cards are missing, where the
program or the benchmark's files are missing, or where ``jax``, ``jaxlib``,
``flax`` or ``team_tpu`` was imported by the time the window closed. The
compared numbers go to the end of standard error and, under ``checks``, to
the end of the result line, the last line of standard output.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "team_tpu")
KNOB_PREFIX = "TEAM_"


def forbidden_modules() -> list:
    """Top-level names of loaded modules that must not be, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def prepare_environment() -> None:
    """No ambient knob of the program applies (its configuration is the
    cell's); build and kernel caches live at fixed paths inside the checkout
    (the program's own nvcc builds go to ``build/team_tpu_torch/`` there)."""
    for key in [k for k in os.environ if k.startswith(KNOB_PREFIX)]:
        del os.environ[key]
    cache = ROOT / "build" / "teambench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(cache / sub)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from teambench.manifest import Manifest

    manifest = Manifest(ROOT)
    wl = manifest.workload(args.workload)
    prepare_environment()

    t_import = time.perf_counter()
    import torch

    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"teambench: {args.workload} needs {wl['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    from teambench import cell

    result = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                      manifest=manifest, device=torch.device("cuda", 0), t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"teambench: modules loaded that the port must not load: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    phases = dict(result["setup_phases_s"], start=t_import - T_START, torch_import=t_torch - t_import)
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
