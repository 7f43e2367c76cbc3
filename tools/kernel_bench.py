#!/usr/bin/env python
"""Micro-bench: ONLY the flagship config (bonsai 256^3 @1024^2) on one GPU —
for kernel A/B runs without the rest of bench.py's configs.

    python tools/kernel_bench.py [width height]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    from bench import bench_bonsai
    from vokselis.ops import backend
    from vokselis.utils.chip import card_line

    backend.require_gpu()
    width = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    height = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    bench_bonsai(card_line(), name=f"bonsai_{width}x{height}", width=width,
                 height=height)


if __name__ == "__main__":
    main()
