"""Oracle renderer tests: closed-form compositing cases and structural
invariants (SURVEY.md §4 points 1-2)."""

import numpy as np
import jax.numpy as jnp
import pytest

from vokselis.core.camera import Camera
from vokselis.core.colors import linear_to_srgb, smoothstep, vertigo
from vokselis.ops.reference import (
    render_bonsai,
    render_compute_inline,
    render_compute_tex,
    render_field,
)
from vokselis.volume import fields
from vokselis.volume.io import get_bonsai


class TestBonsai:
    def test_miss_is_opaque_black(self):
        vol = jnp.zeros((8, 8, 8), jnp.uint8)
        # camera far away looking AWAY from the box
        cam = Camera(zoom=5.0, pitch=0.0, yaw=0.0, target=(0.0, 0.0, -100.0), aspect=1.0)
        img = render_bonsai(vol, cam.uniform(), width=8, height=8, max_steps=4)
        np.testing.assert_allclose(np.asarray(img[..., :3]), 0.0, atol=1e-7)
        np.testing.assert_allclose(np.asarray(img[..., 3]), 1.0)

    def test_empty_volume_black(self):
        vol = jnp.zeros((8, 8, 8), jnp.uint8)
        img = render_bonsai(vol, Camera.bonsai(1.0).uniform(), width=16, height=16)
        # empty volume: transfer gives alpha 0 -> black everywhere
        np.testing.assert_allclose(np.asarray(img[..., :3]), 0.0, atol=1e-6)

    def test_uniform_volume_saturates_to_palette(self):
        # a uniform dense volume: every step composites the same color, so
        # saturated pixels must equal srgb(vertigo(a)) for a = smoothstep
        # transfer of the density
        density = 200
        vol = jnp.full((16, 16, 16), density, jnp.uint8)
        img = render_bonsai(vol, Camera.bonsai(1.0).uniform(), width=32, height=32)
        r = density / 255.0
        a = float(smoothstep(0.10, 1.2, min(0.9, r)))
        expected = np.asarray(linear_to_srgb(vertigo(jnp.float32(a))))
        center = np.asarray(img[16, 16, :3])
        # alpha saturates (>0.95) in a few steps; accumulated color tends to
        # vertigo(a) exactly as alpha -> 1
        np.testing.assert_allclose(center, expected, atol=0.02)

    def test_synthetic_bonsai_has_structure(self):
        vol = jnp.asarray(get_bonsai(128))
        img = render_bonsai(vol, Camera.bonsai(1.0).uniform(), width=64, height=64)
        rgb = np.asarray(img[..., :3])
        assert rgb.max() > 0.3, "expected visible content"
        assert (rgb.sum(-1) == 0).mean() > 0.1, "expected some background"

    def test_dt_scale_changes_step_count_not_look(self):
        vol = jnp.asarray(get_bonsai(64))
        u = Camera.bonsai(1.0).uniform()
        a = render_bonsai(vol, u, width=32, height=32, dt_scale=1.0)
        b = render_bonsai(vol, u, width=32, height=32, dt_scale=0.5)
        # finer steps accumulate more alpha per distance -> brighter-or-equal,
        # but same silhouette
        sil_a = np.asarray(a[..., :3]).sum(-1) > 1e-3
        sil_b = np.asarray(b[..., :3]).sum(-1) > 1e-3
        assert (sil_a == sil_b).mean() > 0.95


class TestComputePath:
    def test_inline_matches_texture_variant(self):
        """The inline-field evaluation must place samples exactly where the
        precomputed-texture variant does (the gather-free form)."""
        dims = 32
        dens, nrm = fields.generate_xor_volumes(dims, time=0.0)
        u = Camera.xor(1.0).uniform()
        a = np.asarray(render_compute_tex(dens, nrm, u, width=48, height=48))
        b = np.asarray(render_compute_inline(u, width=48, height=48, dims=dims))
        # the fract(sin(x)*43758.5) hash amplifies fma-fusion differences at
        # lattice boundaries into O(1e-3) pixel deltas on a small fraction of
        # pixels; everywhere else agreement is exact
        err = np.abs(a - b)
        assert err.max() < 5e-3
        assert (err < 1e-5).mean() > 0.97
        assert np.abs(a - b).mean() < 5e-6

    def test_miss_pixels_are_clear_color(self):
        u = Camera.xor(1.0).uniform()
        img = render_compute_inline(u, width=32, height=32, dims=8, max_steps=8)
        corner = np.asarray(img[0, 0])
        np.testing.assert_allclose(corner, [0.023, 0.02, 0.02, 1.0], atol=1e-6)

    def test_initial_alpha_tint(self):
        """get_col2 starts at alpha 0.1 (raycast_compute.wgsl:61): a ray that
        hits the box but accumulates nothing must still return the clear rgb."""

        def empty_field(coord, time):
            v = jnp.zeros_like(coord[..., 0])
            return jnp.stack([v, v, v, v], axis=-1)

        u = Camera.xor(1.0).uniform()
        img = render_compute_inline(
            u, width=16, height=16, dims=8, max_steps=8, field=empty_field
        )
        np.testing.assert_allclose(
            np.asarray(img[8, 8]), [0.023, 0.02, 0.02, 1.0], atol=1e-6
        )

    def test_render_field_trig(self):
        img = render_field(Camera.xor(1.0).uniform(), width=32, height=32)
        assert img.shape == (32, 32, 4)
        assert np.isfinite(np.asarray(img)).all()
        assert float(img[..., :3].max()) > 0.03  # some content over clear color
