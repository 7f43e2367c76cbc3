#!/usr/bin/env python
"""Pixel comparison against the reference's committed trig screenshot
(/root/reference/trig.png, README.md:9) — the remaining ASSET-FREE golden
(volume.png is done at 0.894 correlation; bonsai.png is blocked on the
real CT volume).

The screenshot is 958x1050 at an unknown runtime time/camera: the triangle
color is (fract(time), mouse_pressed, 1, 1) (shader_with_camera.wgsl:43),
so the red channel pins fract(time) directly, and the default orbit camera
should reproduce the pose (small offsets searched like volume_png_compare).
Renders our FULL pipeline: rasterize_triangle at the fixed 1280x720
backbuffer -> present resize/tonemap at the screenshot's window size.

Usage: python tools/trig_png_compare.py
"""
from __future__ import annotations

import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from PIL import Image

    from vokselis.core.camera import Camera, CameraUniform
    from vokselis.media.png import write_png
    from vokselis.models.trig import _V0, _V1, _V2
    from vokselis.ops.present import present
    from vokselis.ops.raster import rasterize_triangle

    ref_path = "/root/reference/trig.png"
    ref = np.asarray(Image.open(ref_path).convert("RGB"), np.float32) / 255.0
    rh, rw = ref.shape[:2]
    aspect = rw / rh

    # fract(time) from the triangle's sRGB red level: invert the present
    # tonemap numerically over a ramp (the triangle is flat-colored)
    tri_mask = ref[..., 2] > 0.5
    red_srgb = float(np.median(ref[..., 0][tri_mask]))

    @jax.jit
    def render_one(vp, pv, ip, t):
        color = jnp.stack([t, jnp.float32(0.0), jnp.float32(1.0),
                           jnp.float32(1.0)])
        img = rasterize_triangle(CameraUniform(vp, pv, ip).proj_view,
                                 _V0, _V1, _V2, color, 1280, 720)
        return present(img, out_height=rh, out_width=rw)

    base = Camera.default(aspect)
    u0 = base.uniform()
    # invert present's ACES+sRGB on the red channel over a ramp
    ramp = np.linspace(0.0, 1.0, 257, dtype=np.float32)
    probe = np.asarray(render_one(u0.view_position, u0.proj_view,
                                  u0.inv_proj, jnp.float32(0.5)))
    del probe  # warm the jit only
    from vokselis.core.colors import aces_film, linear_to_srgb_present

    mapped = np.asarray(linear_to_srgb_present(aces_film(jnp.asarray(ramp))))
    t_best = float(ramp[int(np.abs(mapped - red_srgb).argmin())])

    def down(img, f=6):
        h, w = img.shape[:2]
        return img[: h // f * f, : w // f * f].reshape(
            h // f, f, w // f, f, 3).mean((1, 3))

    ref_d = down(ref)

    def score_pose(zoom, yaw, pitch):
        cam = Camera(zoom=zoom, pitch=pitch, yaw=yaw, target=base.target,
                     aspect=aspect)
        u = cam.uniform()
        img = np.asarray(render_one(u.view_position, u.proj_view,
                                    u.inv_proj,
                                    jnp.float32(t_best)))[..., :3]
        a = down(img) - down(img).mean((0, 1))
        b = ref_d - ref_d.mean((0, 1))
        corr = float((a * b).sum() / max(
            np.sqrt((a * a).sum() * (b * b).sum()), 1e-9))
        return corr, img

    # the screenshot's pose is a runtime drag (the default yaw-1.0 view is
    # visibly skewed; the committed image is near-symmetric): coarse yaw
    # sweep first, then refine around the best
    best = (-2.0, None, None)
    for yaw in np.linspace(0.0, math.pi, 13):
        corr, img = score_pose(1.0, float(yaw), 0.0)
        if corr > best[0]:
            best = (corr, (1.0, float(yaw), 0.0), img)
    cz, cy, cp = best[1]
    for zoom in (0.85, 0.95, 1.0, 1.05, 1.15, 1.25):
        for dyaw in (-0.13, -0.065, 0.0, 0.065, 0.13):
            for pitch in (-0.1, -0.05, 0.0, 0.05, 0.1):
                corr, img = score_pose(zoom, cy + dyaw, pitch)
                if corr > best[0]:
                    best = (corr, (zoom, cy + dyaw, pitch), img)

    corr, params, img = best
    err = np.abs(img - ref)
    print(f"fract(time) from red channel: {t_best:.3f} "
          f"(srgb red {red_srgb:.3f})")
    print(f"best color correlation: {corr:.4f} at (zoom {params[0]}, "
          f"yaw {params[1]:.3f}, pitch {params[2]:+.2f})")
    print(f"pixel error at best pose: mean={err.mean():.4f} "
          f"p99={np.quantile(err, 0.99):.3f}")
    side = np.concatenate([img, ref], axis=1)
    write_png("trig_cmp.png",
              (np.clip(side, 0, 1) * 255 + 0.5).astype(np.uint8))
    print("side-by-side written to trig_cmp.png (ours | reference)")


if __name__ == "__main__":
    main()
