"""Golden-image regression tests (SURVEY.md §4 point 3).

The scenes, the goldens' location and the tolerance live in
golden_scenes.py next to this file.
"""

import os

import numpy as np
import pytest

import golden_scenes as goldens


def _check(name):
    if not os.path.isfile(os.path.join(goldens.GOLDEN_DIR, name)):
        pytest.skip(f"golden {name} missing — run tools/make_goldens.py")
    goldens.check(name, goldens.render(name))


def test_bonsai_golden():
    _check("bonsai.png")


def test_xor_golden():
    _check("xor.png")


def test_trig_field_golden():
    _check("trig_field.png")


def test_trig_triangle_golden():
    _check("trig.png")


def test_state_roundtrip_reproduces_frame(tmp_path):
    """Checkpoint/resume: a restored state renders the identical frame."""
    from vokselis.engine.context import Context
    from vokselis.engine.state import load_state, save_state
    from vokselis.models.trig import TrigDemo

    ctx = Context(width=64, height=36, backbuffer_resolution=(64, 36))
    ctx.camera.add_yaw(0.3)
    ctx.camera.add_zoom(0.5)
    ctx.update(time=2.5, time_delta=1 / 60)
    demo = TrigDemo.init(ctx)
    demo.render(ctx)
    frame_a = np.asarray(ctx.render())

    p = str(tmp_path / "scene.json")
    save_state(ctx, p)

    ctx2 = Context(width=32, height=32, backbuffer_resolution=(64, 36))
    load_state(ctx2, p)
    demo2 = TrigDemo.init(ctx2)
    demo2.render(ctx2)
    frame_b = np.asarray(ctx2.render())
    np.testing.assert_array_equal(frame_a, frame_b)
