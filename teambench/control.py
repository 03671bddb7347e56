"""Readings that a cell's output-check limits are set from, many seeds in one process.

    python3 teambench/control.py --workload <name> --seeds 11,12,13 [--control] [--fault <name>]

For each seed: the cell's set-up, then a window of the check's first
``check.from_first`` steps, dispatched ahead as in a run, then each number
the run compares (``checks``; a limit's lower reading is the largest over
the seeds). With ``--control`` also the control's number on the same
inputs, against the same reference (``control``; the upper reading is the
smallest): what the configuration's ``check.control`` names, as the
cell's driver computes it. With ``--fault`` the driver plants the named
fault in the program before set-up (``bf16_tower`` for the ``encode``
driver). One JSON line a seed on standard output. The benchmark's runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(manifest, workload: str, seed: int, device, with_control: bool) -> dict:
    from teambench import cell as cells
    from teambench import traffic as gen

    cell = cells.set_up(manifest, workload, seed, device, time.perf_counter())
    span = cell.traffic["check"]["from_first"]
    _, kept = cells.dispatch(cell, lambda i: i >= span, cells.Stamps(device))
    cells.sync(device)
    outputs = {i: kept[i] for i in gen.check_sample(cell.traffic, seed, span)}
    del kept
    row = {"workload": workload, "seed": seed, "steps": sorted(outputs), **cell.system.describe()}
    cell.system.after_window(None)
    cells.free_program(cell)
    checks, _, ok = cell.system.check(outputs)
    row.update(correct=ok, checks={name: c["value"] for name, c in checks.items()})
    if with_control:
        row.update(cell.system.control(sorted(outputs)))
    cells.free_program(cell)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    import pytest
    import torch

    from teambench.manifest import Manifest
    from teambench.run import prepare_environment

    manifest = Manifest(ROOT)
    prepare_environment()
    if not torch.cuda.is_available():
        print("teambench control: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    with pytest.MonkeyPatch.context() as mp:
        if args.fault:
            traffic = manifest.traffic(manifest.workload(args.workload)["traffic"])
            manifest.driver(traffic["driver"]).plant(args.fault, mp)
        for seed in (int(s) for s in args.seeds.split(",")):
            row = readings(manifest, args.workload, seed, device, args.control)
            print(json.dumps(dict(row, fault=args.fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
