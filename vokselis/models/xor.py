"""Xor demo: compute raymarch of the procedural fbm volume
(examples/xor/main.rs:34-281).

Reference structure faithfully rebuilt:

- the volume is 'generated once at init' at time 0 (main.rs:135-146) —
  here the field closure is frozen at gen_time (regenerate by calling
  ``regenerate``; the reference would re-dispatch XorCompute);
- the reference's F1 SinglePass/Tile toggle (main.rs:189-208) chooses a
  compute dispatch shape; here the whole frame is one XLA program, so there
  is nothing to toggle and the demo has no F1 key;
- the GPU timestamp-query pass timing printed every 100 frames
  (main.rs:120-131,164-187) becomes a PassTimer around the march.

The march is the jnp oracle (``render_compute_inline``) on every platform:
its per-step work is field arithmetic that XLA fuses into the loop body.
"""

from __future__ import annotations

from vokselis.core.camera import Camera
from vokselis.engine.demo import Demo
from vokselis.engine.profiler import PassTimer
from vokselis.ops import backend


class FieldPipeline:
    """Reloadable compute-march pipeline (ReloadablePipeline protocol):
    the field callable is re-bound when the watched FIELD SOURCE module
    changes — the reference's edit-shader -> live-swap loop
    (src/watcher.rs:45-54 + examples/bonsai/raycast.rs:137-141), with
    Python field modules playing the role of WGSL files."""

    def __init__(self):
        from vokselis.ops.reference import render_compute_inline
        from vokselis.volume import fields

        self.render = render_compute_inline
        self.field_fn = fields.noise_volume

    def reload(self, module):
        # the oracle takes the field callable as a STATIC jit arg — a
        # fresh function object forces the retrace
        self.field_fn = module.noise_volume


class XorDemo(Demo):
    def __init__(self, gen_time: float):
        self.gen_time = gen_time  # field frozen at init (main.rs:135-146)
        self.timer = PassTimer("raycast shader")
        self.pipeline = FieldPipeline()

    @classmethod
    def init(cls, ctx):
        backend.platform()  # refuse an unsupported device up front
        demo = cls(gen_time=float(ctx.global_uniform.time))
        # register the field source with the context watcher at
        # construction, exactly like the reference's pipelines
        # (examples/bonsai/raycast.rs:137-141)
        from vokselis.volume import fields

        ctx.watcher.register(fields, demo.pipeline)
        return demo

    @staticmethod
    def default_camera(aspect: float) -> Camera:
        # examples/xor/main.rs:270-276
        return Camera.xor(aspect)

    def regenerate(self, ctx):
        """Re-dispatch the volume generation (the reference only does this
        at init; call per-frame for an animated field)."""
        self.gen_time = float(ctx.global_uniform.time)

    def update(self, ctx):
        # timestamp report every 100 frames happens inside PassTimer
        pass

    def render(self, ctx):
        bb = ctx.render_backbuffer
        with self.timer.measure(n_rays=bb.width * bb.height):
            img = self.pipeline.render(
                ctx.camera_uniform,
                time=self.gen_time,
                width=bb.width,
                height=bb.height,
                field=self.pipeline.field_fn,
            ).block_until_ready()
        bb.store(img)
