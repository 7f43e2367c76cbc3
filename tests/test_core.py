"""Unit tests for camera matrices, ray geometry, and color transforms
(SURVEY.md §4: closed-form cases)."""

import math

import numpy as np
import jax.numpy as jnp
import pytest

from vokselis.core import geometry
from vokselis.core.camera import (
    Camera,
    look_at_rh,
    perspective_rh,
    FOVY,
    ZNEAR,
    ZFAR,
)
from vokselis.core.colors import (
    aces_film,
    linear_to_srgb,
    linear_to_srgb_present,
    smoothstep,
    vertigo,
)


class TestCamera:
    def test_fix_eye_formula(self):
        # src/camera.rs:148-157
        cam = Camera(zoom=2.0, pitch=0.3, yaw=0.7, target=(1.0, 2.0, 3.0))
        pc = math.cos(0.3)
        expected = np.array([1.0, 2.0, 3.0]) - 2.0 * np.array(
            [math.sin(0.7) * pc, math.sin(0.3), math.cos(0.7) * pc]
        )
        np.testing.assert_allclose(cam.eye, expected, rtol=1e-6)

    def test_zoom_clamp(self):
        cam = Camera()
        cam.set_zoom(0.01)
        assert cam.zoom == pytest.approx(0.3)
        cam.set_zoom(1000.0)
        assert cam.zoom == pytest.approx(ZFAR / 2.0)
        assert cam.updated

    def test_pitch_clamp_open_interval(self):
        cam = Camera()
        cam.set_pitch(10.0)
        assert cam.pitch < math.pi / 2
        cam.set_pitch(-10.0)
        assert cam.pitch > -math.pi / 2

    def test_look_at_rh_canonical(self):
        # eye at +Z looking at origin: view maps +Z world to -Z view space
        m = look_at_rh((0, 0, 5), (0, 0, 0), (0, 1, 0))
        p = m @ np.array([0.0, 0.0, 0.0, 1.0])
        np.testing.assert_allclose(p, [0, 0, -5, 1], atol=1e-6)
        p = m @ np.array([1.0, 0.0, 5.0, 1.0])
        np.testing.assert_allclose(p, [1, 0, 0, 1], atol=1e-6)

    def test_perspective_rh_depth_range(self):
        # wgpu 0..1 depth: znear -> 0, zfar -> 1
        m = perspective_rh(FOVY, 1.0, ZNEAR, ZFAR)
        near = m @ np.array([0, 0, -ZNEAR, 1.0])
        far = m @ np.array([0, 0, -ZFAR, 1.0])
        assert near[2] / near[3] == pytest.approx(0.0, abs=1e-6)
        assert far[2] / far[3] == pytest.approx(1.0, rel=1e-5)

    def test_uniform_inverse(self):
        u = Camera.bonsai(1280 / 720).uniform()
        ident = np.asarray(u.proj_view) @ np.asarray(u.inv_proj)
        np.testing.assert_allclose(ident, np.eye(4), atol=1e-5)

    def test_target_projects_to_center(self):
        cam = Camera.bonsai(1280 / 720)
        u = cam.uniform()
        x, y, z, w = geometry.mat4_apply(
            u.proj_view, jnp.float32(0.5), jnp.float32(0.5), jnp.float32(0.5)
        )
        assert abs(float(x / w)) < 1e-5
        assert abs(float(y / w)) < 1e-5


class TestGeometry:
    def test_slab_hit_through_center(self):
        t0, t1 = geometry.intersect_box_unit(
            jnp.asarray([0.5, 0.5, -1.0]), jnp.asarray([0.0, 0.0, 1.0])
        )
        assert float(t0) == pytest.approx(1.0)
        assert float(t1) == pytest.approx(2.0)

    def test_slab_miss(self):
        t0, t1 = geometry.intersect_box_unit(
            jnp.asarray([2.0, 2.0, -1.0]), jnp.asarray([0.0, 0.0, 1.0])
        )
        assert float(t0) > float(t1)

    def test_slab_inside(self):
        t0, t1 = geometry.intersect_box_sym(
            jnp.asarray([0.0, 0.0, 0.0]), jnp.asarray([1.0, 0.0, 0.0])
        )
        assert float(t0) == pytest.approx(-1.0)
        assert float(t1) == pytest.approx(1.0)

    def test_fragment_rays_hit_target_pixel(self):
        # the ray through the image center must pass (near) the camera target
        cam = Camera.bonsai(1.0)
        u = cam.uniform()
        eye, dirs = geometry.rays_fragment(u, 65, 65)
        # center pixel (32,32) has ndc (~0,~0): direction toward target
        d = np.asarray(dirs[32, 32])
        expected = np.array([0.5, 0.5, 0.5]) - np.asarray(cam.eye)
        expected /= np.linalg.norm(expected)
        np.testing.assert_allclose(d, expected, atol=5e-2)

    def test_fragment_rays_normalized(self):
        u = Camera.default().uniform()
        _, dirs = geometry.rays_fragment(u, 16, 16)
        np.testing.assert_allclose(
            np.linalg.norm(np.asarray(dirs), axis=-1), 1.0, atol=1e-5
        )

    def test_compute_rays_eye_near_camera(self):
        cam = Camera.xor(16 / 9)
        u = cam.uniform()
        eyes, dirs = geometry.rays_compute(u, 32, 32)
        # unprojected near-plane eyes cluster within ~znear of the camera eye
        d = np.linalg.norm(np.asarray(eyes) - np.asarray(cam.eye), axis=-1)
        assert d.max() < 0.5

    def test_compute_rays_y_quirk(self):
        # the reference scales screen y by -aspect (H/W): for W != H the
        # vertical fov shrinks; verify asymmetry is present
        u = Camera.xor(16 / 9).uniform()
        _, dirs = geometry.rays_compute(u, 160, 90)
        top = np.asarray(dirs[0, 80])
        bottom = np.asarray(dirs[89, 80])
        left = np.asarray(dirs[45, 0])
        right = np.asarray(dirs[45, 159])
        ang_v = math.acos(np.clip(top @ bottom, -1, 1))
        ang_h = math.acos(np.clip(left @ right, -1, 1))
        assert ang_h > ang_v  # horizontal fov wider


class TestColors:
    def test_srgb_roundtrip_anchors(self):
        assert float(linear_to_srgb(jnp.float32(0.0))) == pytest.approx(0.0)
        assert float(linear_to_srgb(jnp.float32(1.0))) == pytest.approx(1.0, abs=1e-6)
        assert float(linear_to_srgb(jnp.float32(0.001))) == pytest.approx(
            12.92 * 0.001, rel=1e-6
        )

    def test_srgb_present_matches_branch_form(self):
        x = jnp.linspace(0.0, 1.0, 256)
        a = linear_to_srgb(x)
        b = linear_to_srgb_present(x)
        # present uses exponent 0.41666 vs 1/2.4=0.41667 — near identical
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-4)

    def test_aces_anchors(self):
        assert float(aces_film(jnp.float32(0.0))) == pytest.approx(0.0, abs=1e-6)
        assert float(aces_film(jnp.float32(10.0))) == pytest.approx(1.0, abs=1e-2)
        v = float(aces_film(jnp.float32(0.5)))
        assert 0.5 < v < 0.8

    def test_smoothstep(self):
        assert float(smoothstep(0.0, 1.0, jnp.float32(0.5))) == pytest.approx(0.5)
        assert float(smoothstep(0.0, 1.0, jnp.float32(-1.0))) == 0.0
        assert float(smoothstep(0.0, 1.0, jnp.float32(2.0))) == 1.0
        # reversed edges (used by xor field, shaders/xor.wgsl:59-60)
        assert float(smoothstep(0.7, 0.0, jnp.float32(0.0))) == pytest.approx(1.0)
        assert float(smoothstep(0.7, 0.0, jnp.float32(0.7))) == pytest.approx(0.0)

    def test_vertigo_shape_and_range(self):
        t = jnp.linspace(0, 1, 7)
        v = vertigo(t)
        assert v.shape == (7, 3)
        assert float(jnp.min(v)) >= 0.0 - 1e-6
        assert float(jnp.max(v)) <= 1.0 + 1e-6


class TestPresentUpsamplers:
    """The present.wgsl:41-92 quadratic + bicubic upsamplers (dead code
    upstream, ported for completeness as present(filter=...))."""

    @staticmethod
    def _ref_bilinear(img, x, y):
        h, w = img.shape[:2]
        x0, y0 = np.floor(x), np.floor(y)
        fx, fy = x - x0, y - y0
        x0, y0 = int(x0), int(y0)
        x0c, x1c = np.clip(x0, 0, w - 1), np.clip(x0 + 1, 0, w - 1)
        y0c, y1c = np.clip(y0, 0, h - 1), np.clip(y0 + 1, 0, h - 1)
        top = img[y0c, x0c] * (1 - fx) + img[y0c, x1c] * fx
        bot = img[y1c, x0c] * (1 - fx) + img[y1c, x1c] * fx
        return top * (1 - fy) + bot * fy

    def test_partition_of_unity(self):
        from vokselis.ops.present import present

        const = jnp.full((12, 20, 4), 0.37, jnp.float32)
        for filt in ("linear", "quadratic", "bicubic"):
            out = np.asarray(present(const, out_height=30, out_width=44,
                                     tonemap=False, filter=filt))
            assert np.abs(out - 0.37).max() < 1e-5, filt

    def test_quadratic_matches_wgsl_transliteration(self):
        """Non-square source pins the shader's textureDimensions(tex).x
        texel-size quirk (present.wgsl:42 uses .x for BOTH axes)."""
        from vokselis.ops.present import present

        rng = np.random.default_rng(0)
        img = rng.random((8, 16, 4)).astype(np.float32)
        oh, ow = 13, 23
        out = np.asarray(present(jnp.asarray(img), out_height=oh,
                                 out_width=ow, tonemap=False,
                                 filter="quadratic"))
        h, w = img.shape[:2]
        n = float(w)  # .x quirk
        want = np.zeros((oh, ow, 4), np.float32)
        for j in range(oh):
            for i in range(ow):
                u, v = (i + 0.5) / ow, (j + 0.5) / oh
                px, py = u * n, v * n
                ix, iy = np.floor(px), np.floor(py)
                fx, fy = px - ix, py - iy
                pu, pv = (ix + fx * 0.5) / n, (iy + fy * 0.5) / n
                fx = fx * fx * (3 - 2 * fx)
                fy = fy * fy * (3 - 2 * fy)
                wo = 0.5 / n
                s = lambda du, dv: self._ref_bilinear(
                    img, (pu + du) * w - 0.5, (pv + dv) * h - 0.5)
                top = s(0, 0) * (1 - fx) + s(wo, 0) * fx
                bot = s(0, wo) * (1 - fx) + s(wo, wo) * fx
                want[j, i] = top * (1 - fy) + bot * fy
        assert np.abs(out - want).max() < 1e-5

    def test_bicubic_matches_wgsl_transliteration(self):
        from vokselis.ops.present import present

        rng = np.random.default_rng(1)
        img = rng.random((9, 14, 4)).astype(np.float32)
        oh, ow = 19, 27
        out = np.asarray(present(jnp.asarray(img), out_height=oh,
                                 out_width=ow, tonemap=False,
                                 filter="bicubic"))
        h, w = img.shape[:2]
        w0 = lambda a: (1 / 6) * (a * (a * (-a + 3) - 3) + 1)
        w1 = lambda a: (1 / 6) * (a * a * (3 * a - 6) + 4)
        w2 = lambda a: (1 / 6) * (a * (a * (-3 * a + 3) + 3) + 1)
        w3 = lambda a: (1 / 6) * (a * a * a)
        g0 = lambda a: w0(a) + w1(a)
        g1 = lambda a: w2(a) + w3(a)
        h0 = lambda a: -1.0 + w1(a) / (w0(a) + w1(a))
        h1 = lambda a: 1.0 + w3(a) / (w2(a) + w3(a))
        want = np.zeros((oh, ow, 4), np.float32)
        for j in range(oh):
            for i in range(ow):
                u, v = (i + 0.5) / ow, (j + 0.5) / oh
                uvx, uvy = u * w + 0.5, v * h + 0.5
                ix, iy = np.floor(uvx), np.floor(uvy)
                fx, fy = uvx - ix, uvy - iy
                want[j, i] = g0(fy) * (
                    g0(fx) * self._ref_bilinear(img, ix + h0(fx) - 0.5,
                                                iy + h0(fy) - 0.5)
                    + g1(fx) * self._ref_bilinear(img, ix + h1(fx) - 0.5,
                                                  iy + h0(fy) - 0.5)
                ) + g1(fy) * (
                    g0(fx) * self._ref_bilinear(img, ix + h0(fx) - 0.5,
                                                iy + h1(fy) - 0.5)
                    + g1(fx) * self._ref_bilinear(img, ix + h1(fx) - 0.5,
                                                  iy + h1(fy) - 0.5)
                )
        assert np.abs(out - want).max() < 1e-5
