"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload infer576.mode0-facebox --seed 7 \
        --seconds 30 --trace 0

Run from the root of a checkout. Exits non-zero, printing no result, when
the card is missing, when the port is missing, or when a module of JAX or
of the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    return harness.run(args)


if __name__ == "__main__":
    sys.exit(main())
