#!/usr/bin/env python
"""Regenerate the golden images for tests/test_golden.py.

Renders the scenes of ``tests/golden_scenes.py`` on the CPU (the jnp
oracles) at their fixed camera/time and writes them to tests/goldens/.
Run from the repo root: python tools/make_goldens.py
"""

import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
os.environ["JAX_PLATFORMS"] = "cpu"

from vokselis.media.png import write_png  # noqa: E402
import golden_scenes as goldens  # noqa: E402


def main():
    os.makedirs(goldens.GOLDEN_DIR, exist_ok=True)
    for name in goldens.SCENES:
        write_png(os.path.join(goldens.GOLDEN_DIR, name), goldens.render(name))
    print(f"goldens written to {goldens.GOLDEN_DIR}")


if __name__ == "__main__":
    main()
