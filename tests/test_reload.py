"""Hot-reload end-to-end: the edit-field -> live-swap loop
(src/watcher.rs:45-110), driven through XorDemo's registered pipeline."""

FIELD_V1 = """
import jax.numpy as jnp

def noise_volume(coord, time=0.0):
    val = jnp.full(coord.shape[:-1], 0.5, jnp.float32)
    r = jnp.linalg.norm(coord, axis=-1)
    alpha = jnp.where(r < 0.4, 0.6, 0.0)
    return jnp.stack([val, val, val, alpha], axis=-1)
"""

FIELD_V2 = FIELD_V1.replace("0.5,", "0.9,").replace("0.6,", "0.9,")


def test_hot_reload_swaps_xor_field_end_to_end(tmp_path):
    """The reference's signature developer loop (edit shader -> live swap,
    src/watcher.rs:78-90) end-to-end: a field module registered with the
    context watcher is edited on disk; the next poll reloads it, the demo's
    pipeline rebinds, and the rendered output changes."""
    import importlib.util
    import os
    import sys
    import time

    import numpy as np

    from vokselis.engine.context import Context
    from vokselis.models.xor import XorDemo

    path = tmp_path / "hotfield.py"
    path.write_text(FIELD_V1)
    spec = importlib.util.spec_from_file_location("hotfield", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.modules["hotfield"] = mod

    ctx = Context(width=16, height=16, backbuffer_resolution=(16, 16))
    demo = XorDemo.init(ctx)
    # swap the demo onto the editable field module (the oracle path takes
    # the field callable as a static jit arg)
    demo.pipeline.field_fn = mod.noise_volume
    ctx.watcher.register(mod, demo.pipeline)

    demo.render(ctx)
    img_v1 = np.asarray(ctx.render_backbuffer.texture)

    # edit the source on disk; ensure the mtime moves even on coarse clocks
    path.write_text(FIELD_V2)
    st = path.stat()
    os.utime(path, (st.st_atime, st.st_mtime + 2))
    ctx.watcher.poll_once()

    demo.render(ctx)
    img_v2 = np.asarray(ctx.render_backbuffer.texture)

    assert np.isfinite(img_v1).all() and np.isfinite(img_v2).all()
    assert not np.allclose(img_v1, img_v2), "reload did not swap the field"

    # a BROKEN edit keeps the previous kernel alive (watcher.rs:92-101)
    path.write_text("this is not python ][")
    st = path.stat()
    os.utime(path, (st.st_atime, st.st_mtime + 2))
    ctx.watcher.poll_once()
    demo.render(ctx)
    img_v3 = np.asarray(ctx.render_backbuffer.texture)
    np.testing.assert_array_equal(img_v3, img_v2)
    del sys.modules["hotfield"]
