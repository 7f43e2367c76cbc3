"""Trig demo: one camera-transformed triangle (examples/trig.rs:74-130).

The BasicPipeline render pass (clear to black, draw 3 vertices through
proj_view with FS color ``(fract(time), mouse_pressed, 1, 1)``,
shaders/shader_with_camera.wgsl:26-45) becomes a jitted rasterize call into
the HDR backbuffer.
"""

from __future__ import annotations

import jax.numpy as jnp

from vokselis.core.camera import Camera
from vokselis.core.colors import fract
from vokselis.engine.demo import Demo
from vokselis.ops.raster import rasterize_triangle

# shader_with_camera.wgsl:29-37
_V0 = jnp.asarray([-0.5, -0.5, 0.0], jnp.float32)
_V1 = jnp.asarray([0.5, -0.5, 0.0], jnp.float32)
_V2 = jnp.asarray([0.0, 0.5, 0.0], jnp.float32)


class TrigDemo(Demo):
    @classmethod
    def init(cls, ctx):
        return cls()

    @staticmethod
    def default_camera(aspect: float) -> Camera:
        # trig passes None; Context uses the default pose (src/context.rs:124)
        return Camera.default(aspect)

    def render(self, ctx):
        un = ctx.global_uniform
        color = jnp.stack(
            [
                fract(un.time),
                un.mouse_pressed.astype(jnp.float32),
                jnp.float32(1.0),
                jnp.float32(1.0),
            ]
        )
        bb = ctx.render_backbuffer
        img = rasterize_triangle(
            ctx.camera_uniform.proj_view,
            _V0, _V1, _V2, color,
            bb.width, bb.height,
        )
        bb.store(img)
