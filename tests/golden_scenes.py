"""The golden-image scenes of goldens/ (next to this file) and their
comparison, shared by test_golden.py, tools/make_goldens.py and
chip_smoke.py (which checks the same goldens on the card).

Four small fixed scenes (the reference's de-facto goldens are
trig.png/bonsai.png/volume.png in its repo root, README.md:9,15,21 — these
are small deterministic equivalents). The bonsai scene renders through the
backend dispatch, so on a GPU it checks the march kernel; the others are
oracles that XLA compiles on every platform. Tolerances are in uint8 levels:
compiler drift is ~1 level on a small pixel fraction; a real regression
shifts whole regions.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

from vokselis.core.camera import Camera
from vokselis.media.png import read_png
from vokselis.ops.present import present, to_uint8

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens")
SIZE = (160, 90)  # (width, height)
# fixed scene parameters — changing ANY of these invalidates the goldens
BONSAI_CAM = dict(zoom=1.0, pitch=0.5, yaw=1.0, target=(0.5, 0.5, 0.5))
XOR_CAM = dict(zoom=3.0, pitch=-0.5, yaw=1.0, target=(0.0, 0.0, 0.0))
TIME = 0.0


def _bonsai(w, h):
    from vokselis.ops import backend
    from vokselis.volume.io import get_bonsai

    cam = Camera(aspect=w / h, **BONSAI_CAM)
    return backend.render_bonsai(jnp.asarray(get_bonsai()), cam.uniform(),
                                 width=w, height=h)


def _xor(w, h):
    from vokselis.ops.reference import render_compute_inline

    cam = Camera(aspect=w / h, **XOR_CAM)
    return render_compute_inline(cam.uniform(), time=TIME, width=w, height=h)


def _trig_field(w, h):
    from vokselis.ops.reference import render_field

    cam = Camera(aspect=w / h, **XOR_CAM)
    return render_field(cam.uniform(), time=TIME, width=w, height=h)


def _trig(w, h):
    # the literal trig demo triangle at time 0.25
    from vokselis.ops.raster import rasterize_triangle

    cam = Camera.default(aspect=w / h)
    return rasterize_triangle(
        cam.uniform().proj_view,
        jnp.asarray([-0.5, -0.5, 0.0]), jnp.asarray([0.5, -0.5, 0.0]),
        jnp.asarray([0.0, 0.5, 0.0]),
        jnp.asarray([0.25, 0.0, 1.0, 1.0], jnp.float32), w, h,
    )


SCENES = {
    "bonsai.png": _bonsai,
    "xor.png": _xor,
    "trig_field.png": _trig_field,
    "trig.png": _trig,
}


def render(name: str) -> np.ndarray:
    """The scene ``name`` as the uint8 image the golden stores."""
    w, h = SIZE
    return np.asarray(to_uint8(present(SCENES[name](w, h))))


def compare(name: str, img_u8) -> dict:
    """Errors of ``img_u8`` against the stored golden, in uint8 levels."""
    gold = read_png(os.path.join(GOLDEN_DIR, name)).astype(np.int32)
    err = np.abs(np.asarray(img_u8, np.int32) - gold)
    return {"mean": float(err.mean()), "share_gt_8": float((err > 8).mean())}


def check(name: str, img_u8) -> dict:
    """:func:`compare`, raising AssertionError outside the tolerance."""
    e = compare(name, img_u8)
    assert e["mean"] < 1.0, f"{name}: mean err {e['mean']}"
    assert e["share_gt_8"] < 0.01, (
        f"{name}: {e['share_gt_8']:.3%} px off by >8")
    return e
