"""Tiny jnp triangle rasterizer — the trig demo's render path.

The reference's trig demo draws one camera-transformed triangle with a
solid-ish fragment color (shaders/shader_with_camera.wgsl:26-45,
examples/trig.rs). Here a 3-vertex draw is a pure elementwise coverage
test: clip -> NDC -> viewport, then edge functions at pixel centers (the
wgpu default PrimitiveState: no culling, CCW front face — coverage here is
winding-agnostic like a cull_mode=None draw).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from vokselis.core.geometry import mat4_apply, pixel_centers


@partial(jax.jit, static_argnames=("width", "height"))
def rasterize_triangle(proj_view, v0, v1, v2, color, width: int, height: int,
                       background=(0.0, 0.0, 0.0, 1.0)):
    """Rasterize one triangle over a (height, width, 4) framebuffer.

    ``v*``: (3,) object-space vertices; ``color``: (4,); transforms by
    ``proj_view`` like vs_main (shader_with_camera.wgsl:26-40).
    """
    verts = []
    for v in (v0, v1, v2):
        x, y, z, w = mat4_apply(proj_view, v[0], v[1], v[2])
        # viewport transform at pixel centers (wgpu NDC: y up)
        sx = (x / w + 1.0) * 0.5 * width
        sy = (1.0 - y / w) * 0.5 * height
        verts.append((sx, sy, w))
    px, py = pixel_centers(width, height)

    def edge(ax, ay, bx, by):
        return (bx - ax) * (py - ay) - (by - ay) * (px - ax)

    e01 = edge(verts[0][0], verts[0][1], verts[1][0], verts[1][1])
    e12 = edge(verts[1][0], verts[1][1], verts[2][0], verts[2][1])
    e20 = edge(verts[2][0], verts[2][1], verts[0][0], verts[0][1])
    inside = ((e01 >= 0) & (e12 >= 0) & (e20 >= 0)) | (
        (e01 <= 0) & (e12 <= 0) & (e20 <= 0)
    )
    # reject triangles behind the camera (all w <= 0)
    visible = (verts[0][2] > 0) & (verts[1][2] > 0) & (verts[2][2] > 0)
    inside = inside & visible

    color = jnp.asarray(color, jnp.float32)
    background = jnp.asarray(background, jnp.float32)
    return jnp.where(inside[..., None], color, background)


# --- unreferenced reference leftovers, kept for inventory parity (K6) -----

@partial(jax.jit, static_argnames=("width", "height"))
def cameraless_triangle(time, width: int, height: int):
    """shaders/shader.wgsl:19-36 — clip-space triangle, no camera; FS color
    (fract(time), 0, 1, 1)-style. Not used by any demo (like the original)."""
    ident = jnp.eye(4, dtype=jnp.float32)
    t = time - jnp.floor(time)
    color = jnp.stack([t, jnp.zeros_like(t), jnp.ones_like(t), jnp.ones_like(t)])
    return rasterize_triangle(
        ident,
        jnp.asarray([-0.5, -0.5, 0.0]), jnp.asarray([0.5, -0.5, 0.0]),
        jnp.asarray([0.0, 0.5, 0.0]), color, width, height,
    )


@partial(jax.jit, static_argnames=("width", "height"))
def magenta_mini_triangle(width: int, height: int):
    """shaders/shader_sec.wgsl:6-22 — small magenta triangle. Unused."""
    ident = jnp.eye(4, dtype=jnp.float32)
    return rasterize_triangle(
        ident,
        jnp.asarray([-0.25, -0.25, 0.0]), jnp.asarray([0.25, -0.25, 0.0]),
        jnp.asarray([0.0, 0.25, 0.0]),
        jnp.asarray([1.0, 0.0, 1.0, 1.0]), width, height,
    )


@partial(jax.jit, static_argnames=("width", "height"))
def fullscreen_quad(width: int, height: int, color=(1.0, 1.0, 1.0, 1.0)):
    """shaders/quad.wgsl:6-14 — fullscreen white quad. Unused."""
    return jnp.broadcast_to(
        jnp.asarray(color, jnp.float32), (height, width, 4)
    )
