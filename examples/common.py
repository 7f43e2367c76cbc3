"""Shared CLI for the example demos (the reference's example main() shape:
window setup + camera + run, e.g. examples/bonsai/main.rs:60-76)."""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def make_parser(name: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=f"vokselis {name} demo")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--out", type=str, default=None,
                   help="write the final frame as PNG here")
    p.add_argument("--orbit", action="store_true",
                   help="orbit the camera (drag-equivalent) during the run")
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    p.add_argument("--watch", action="store_true",
                   help="hot-reload registered field/kernel sources on edit")
    return p


def orbit_events(frames: int, width: int, height: int):
    """Scripted mouse-drag orbit: one event stream, one drag per frame."""
    x, y = width / 2, height / 2
    yield {"type": "mouse_button", "pressed": True}
    for i in range(frames):
        x += 8.0
        y += 1.5
        yield {"type": "mouse_move", "x": x, "y": y, "dragging": True}
        yield None  # frame boundary


def finish(ctx, args):
    if args.out:
        import numpy as np

        from vokselis.media.png import write_png
        from vokselis.ops.present import to_uint8

        write_png(args.out, np.asarray(to_uint8(ctx.display_image)))
        print(f"wrote {args.out}")


def maybe_cpu(args):
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
