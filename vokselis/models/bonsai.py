"""Bonsai demo: fragment-raymarch of the 256^3 uint8 CT volume
(examples/bonsai/main.rs:10-76).

The march runs where :mod:`vokselis.ops.backend` says: the Pallas kernel on
a GPU, the jnp oracle on the CPU. The raymarch output already applies
linear_to_srgb (raycast_naive.wgsl:121-124); the present pass then tonemaps
on top, exactly like the reference's two-stage chain.
"""

from __future__ import annotations

from vokselis.core.camera import Camera
from vokselis.engine.demo import Demo
from vokselis.ops.backend import BonsaiRenderer
from vokselis.volume.io import get_bonsai


class BonsaiDemo(Demo):
    def __init__(self, renderer, vol):
        self.renderer = renderer
        self.vol = vol

    @classmethod
    def init(cls, ctx):
        vol = get_bonsai()
        return cls(BonsaiRenderer(vol), vol)

    @staticmethod
    def default_camera(aspect: float) -> Camera:
        # examples/bonsai/main.rs:68-73
        return Camera.bonsai(aspect)

    def render(self, ctx):
        bb = ctx.render_backbuffer
        img = self.renderer(ctx.camera_uniform, bb.width, bb.height)
        bb.store(img)
