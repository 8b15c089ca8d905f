"""Shared CLI plumbing: the device, the seed."""
from __future__ import annotations

import argparse

import torch


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", default="cuda",
        help="Device to build the model and run the fit on (default cuda; cpu for tests).",
    )
    parser.add_argument("--seed", type=int, default=0, help="Base RNG seed for reproducibility.")


def setup_platform(args: argparse.Namespace) -> torch.device:
    """The device of ``--device``; raises when it names a CUDA device and
    none is visible (``core.device.target_device``)."""
    from ..core.device import target_device

    return target_device(args.device)
