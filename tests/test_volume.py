"""Tests for volume IO, sampler semantics, and procedural fields."""

import numpy as np
import jax.numpy as jnp
import pytest

from vokselis.volume import fields
from vokselis.volume.io import get_bonsai, load_raw, synthetic_bonsai
from vokselis.volume.sample import sample_nearest, sample_trilinear_r8


class TestIO:
    def test_synthetic_bonsai_deterministic(self):
        a = synthetic_bonsai(64)
        b = synthetic_bonsai(64)
        assert a.shape == (64, 64, 64)
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)

    def test_synthetic_bonsai_occupancy(self):
        v = synthetic_bonsai(128)
        occ = (v > 0).mean()
        assert 0.02 < occ < 0.4, f"occupancy {occ} not CT-like"

    def test_load_raw_roundtrip(self, tmp_path):
        v = np.arange(4 * 4 * 4, dtype=np.uint8).reshape(4, 4, 4)
        p = tmp_path / "t.raw"
        v.tofile(p)
        r = load_raw(str(p), (4, 4, 4))
        np.testing.assert_array_equal(v, r)

    def test_load_raw_size_mismatch(self, tmp_path):
        p = tmp_path / "t.raw"
        np.zeros(5, np.uint8).tofile(p)
        with pytest.raises(ValueError):
            load_raw(str(p), (4, 4, 4))

    def test_get_bonsai_cached(self):
        assert get_bonsai(64) is get_bonsai(64)


class TestSampler:
    def test_trilinear_at_texel_centers(self):
        # at texel centers (u = (i+0.5)/N) the sample equals the texel value
        vol = jnp.asarray(np.random.default_rng(0).integers(0, 255, (8, 8, 8)), jnp.uint8)
        i = jnp.asarray([3, 5, 2], jnp.float32)
        p = (i + 0.5) / 8.0
        v = sample_trilinear_r8(vol, p)
        assert float(v) == pytest.approx(int(vol[2, 5, 3]) / 255.0, abs=1e-6)

    def test_trilinear_midpoint(self):
        vol = np.zeros((2, 2, 2), np.uint8)
        vol[0, 0, 0] = 255  # value 1 at (x=0,y=0,z=0)
        vol = jnp.asarray(vol)
        # halfway between the two x texels at y=z=0 face (clamped)
        p = jnp.asarray([0.5, 0.25, 0.25], jnp.float32)
        v = sample_trilinear_r8(vol, p)
        assert float(v) == pytest.approx(0.5, abs=1e-6)

    def test_trilinear_clamp_to_edge(self):
        vol = np.full((4, 4, 4), 100, np.uint8)
        vol = jnp.asarray(vol)
        v = sample_trilinear_r8(vol, jnp.asarray([-0.5, 0.5, 0.5]))
        assert float(v) == pytest.approx(100 / 255.0, abs=1e-6)
        v = sample_trilinear_r8(vol, jnp.asarray([1.5, 1.5, 1.5]))
        assert float(v) == pytest.approx(100 / 255.0, abs=1e-6)

    def test_nearest_multichannel(self):
        vol = np.zeros((4, 4, 4, 4), np.float32)
        vol[1, 2, 3] = [1, 2, 3, 4]
        v = sample_nearest(jnp.asarray(vol), jnp.asarray([3, 2, 1], jnp.int32))
        np.testing.assert_allclose(np.asarray(v), [1, 2, 3, 4])

    def test_nearest_oob_clamped(self):
        vol = np.arange(8, dtype=np.float32).reshape(2, 2, 2)
        v = sample_nearest(jnp.asarray(vol), jnp.asarray([99, 99, 99], jnp.int32))
        assert float(v) == 7.0


class TestFields:
    def test_hash_range(self):
        h = fields.hash_(jnp.linspace(0.0, 1000.0, 101))
        assert float(jnp.min(h)) >= 0.0
        assert float(jnp.max(h)) <= 1.0

    def test_noise_interpolates_lattice(self):
        # at integer lattice points noise == hash of the lattice index
        p = jnp.asarray([3.0, 4.0, 5.0])
        n = fields.noise(p)
        expected = fields.hash_(jnp.float32(3.0 + 4.0 * 157.0 + 113.0 * 5.0))
        assert float(n) == pytest.approx(float(expected), abs=1e-5)

    def test_fbm_range(self):
        g = jnp.linspace(-2, 2, 8)
        pts = jnp.stack(jnp.meshgrid(g, g, g, indexing="ij"), axis=-1)
        f = fields.fbm(pts * 32.0)
        assert float(jnp.min(f)) >= 0.0
        assert float(jnp.max(f)) <= 0.875 + 1e-4  # 0.5+0.25+0.125

    def test_noise_volume_alpha_windowed(self):
        # alpha must vanish beyond |coord| = 0.5 (smoothstep(0.5, 0.25, r))
        far = fields.noise_volume(jnp.asarray([0.6, 0.0, 0.0]))
        assert float(far[3]) == pytest.approx(0.0, abs=1e-7)

    def test_xor_field_bitwise(self):
        # value is f32(i32(px*25) & i32(py*25) & i32(pz*25)) / 25
        coord = jnp.asarray([0.1, 0.05, -0.2])
        v = fields.xor_field(coord, time=0.0)
        pos = (np.array([0.1, 0.05, -0.2]) + np.array([1.0, 0.0, 21.0])) * 32.0
        q = (pos * 25.0).astype(np.int32)
        expected = float(q[0] & q[1] & q[2]) / 25.0
        assert float(v[0]) == pytest.approx(expected, rel=1e-5)

    def test_gradient_normalized(self):
        g = fields.gradient(jnp.asarray([[0.1, 0.2, 0.3], [0.0, 0.1, 0.0]]))
        np.testing.assert_allclose(
            np.linalg.norm(np.asarray(g), axis=-1), 1.0, atol=1e-5
        )

    def test_generate_xor_volumes_matches_pointwise(self):
        dens, nrm = fields.generate_xor_volumes(8, time=0.0)
        assert dens.shape == (8, 8, 8, 4)
        # voxel (x=2, y=3, z=4): coord = (gid - 4)/8
        coord = (jnp.asarray([2.0, 3.0, 4.0]) - 4.0) / 8.0
        v = fields.noise_volume(coord)
        np.testing.assert_allclose(
            np.asarray(dens[4, 3, 2]),
            np.asarray(jnp.concatenate([v[:3] / 2.0, v[3:]])),
            rtol=1e-5,
        )
