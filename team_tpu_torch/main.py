"""CLI entry point (counterpart of ``team_tpu/main.py``): argparse merged with
a JSON experiment file, the JSON winning.

    python -m team_tpu_torch.main --config exps/synthetic_smoke.json --device 0

``--device`` takes a CUDA device index or ``cpu``, or one per rank
(``0,0``: two ranks share card 0). Data parallel over N ranks, one process
per device (a config with ``"mesh_shape": [N]``):

    torchrun --nproc_per_node N -m team_tpu_torch.main --config cfg.json
"""

from __future__ import annotations

import argparse

from team_tpu_torch.config import load_config
from team_tpu_torch.trainer import train


def setup_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="TEAM temporal-evolution CIL (PyTorch/CUDA)")
    parser.add_argument("--config", type=str, default="./exps/IIMinsects202.json")
    parser.add_argument("--name", type=str, default="")
    parser.add_argument("--model_name", type=str, default="proof")
    parser.add_argument("--dataset", type=str, default="iiminsects202")
    parser.add_argument("--device", type=str, default="0")
    parser.add_argument("--data_root", type=str, default=None)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--temporal", action="store_true")
    return parser


def main() -> None:
    args = setup_parser().parse_args()
    overrides = vars(args).copy()
    overrides["device"] = ["cpu" if d.strip() == "cpu" else int(d)
                           for d in str(overrides["device"]).split(",")]
    cfg = load_config(args.config, overrides=overrides)
    train(cfg)


if __name__ == "__main__":
    main()
