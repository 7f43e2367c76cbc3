"""The config-5 volume generator against a pointwise field evaluation."""

import numpy as np
import jax.numpy as jnp
import pytest

from vokselis.volume import fields


@pytest.mark.parametrize("dims,time", [(8, 0.0), (16, 1.25), (12, 3.0)])
def test_generate_density_u8_matches_field(dims, time):
    """Every voxel is the radially masked fbm alpha of ``noise_volume`` at
    the voxel's coordinate, quantized to uint8."""
    got = np.asarray(fields.generate_density_u8(time, dims))
    assert got.shape == (dims,) * 3 and got.dtype == np.uint8
    half = dims / 2.0
    z, y, x = np.meshgrid(*([np.arange(dims, dtype=np.float32)] * 3),
                          indexing="ij")
    coord = np.stack([(x - half) / dims, (y - half) / dims,
                      (z - half) / dims], axis=-1)
    alpha = np.asarray(fields.noise_volume(jnp.asarray(coord), time))[..., 3]
    want = np.clip(alpha * 255.0 + 0.5, 0, 255).astype(np.uint8)
    assert (np.abs(got.astype(int) - want.astype(int)) <= 1).all()
    assert (got == want).mean() > 0.99


def test_generate_density_u8_varies_in_time():
    a = np.asarray(fields.generate_density_u8(0.0, 16))
    b = np.asarray(fields.generate_density_u8(1.5, 16))
    assert (a != b).any()
    assert 0.05 < (a > 0).mean() < 0.95
