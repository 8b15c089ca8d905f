"""mach3-combine-torch — merge chain files with reproducibility enforcement (port of
``mach3_tpu/cli/combine.py``).

CLI equivalent of ``Diagnostics/CombineMaCh3Chains.cpp``: refuses to merge
chains produced by different framework versions or configs unless --force.

The work is numpy on the host. ``--device`` (default cuda) is checked as in
every CLI of this package; it names no device that the work runs on.
"""
from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("chains", nargs="+")
    parser.add_argument("--output", "-o", required=True)
    parser.add_argument(
        "--force", action="store_true", help="Skip version/config equality checks"
    )
    from .common import add_common_args, setup_platform

    add_common_args(parser)
    args = parser.parse_args(argv)
    setup_platform(args)

    from ..core.exceptions import MaCh3Error
    from ..diagnostics.chain_io import combine_chains

    try:
        combine_chains(args.chains, args.output, check=not args.force)
    except MaCh3Error as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    print(f"combined {len(args.chains)} files -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
