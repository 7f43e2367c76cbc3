"""The bonsai march kernel (Pallas, Triton route) against the jnp oracle.

Here on the CPU the kernel runs in interpret mode, at small sizes (<= 64^2
frames, <= 32^3 volumes); the CUDA-lowering tests lower it for the GPU at
real widths, which catches primitives the Triton route cannot lower. Tests
marked ``gpu`` compile it for the card and skip without one (chip_smoke.py
covers the same ground on the card).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vokselis.core import geometry
from vokselis.core.camera import Camera, CameraUniform
from vokselis.ops import reference
from vokselis.ops.pallas import march_bonsai as mb
from vokselis.volume.io import dense_stress, get_bonsai

TARGET = (0.5, 0.5, 0.5)
POSES = {
    "bench": dict(zoom=1.0, pitch=0.5, yaw=1.0),
    "axis_aligned": dict(zoom=1.0, pitch=0.0, yaw=0.0),
    "eye_inside": dict(zoom=0.3, pitch=0.1, yaw=0.7),
    "pitch_near_pole": dict(zoom=1.0, pitch=math.pi / 2 - 1e-3, yaw=0.3),
    "orbit": dict(zoom=1.0, pitch=0.5, yaw=2.0 * math.pi * 5 / 8),
}


def _volume(kind, n=32):
    rng = np.random.default_rng(5)
    if kind == "synthetic":
        return get_bonsai(n)
    if kind == "border":  # every voxel filled, edges included
        return rng.integers(30, 220, (n, n, n), dtype=np.uint8)
    if kind == "empty":
        return np.zeros((n, n, n), np.uint8)
    if kind == "uniform":
        return np.full((n, n, n), 128, np.uint8)
    if kind == "dense":
        return dense_stress(n)
    raise ValueError(kind)


def _uniform(pose, width, height):
    return Camera(target=TARGET, aspect=width / height, **POSES[pose]).uniform()


@pytest.mark.parametrize("size", [(64, 64), (48, 40)], ids=["64x64", "48x40"])
@pytest.mark.parametrize("vol_kind",
                         ["synthetic", "border", "empty", "uniform", "dense"])
@pytest.mark.parametrize("pose", list(POSES))
def test_kernel_matches_oracle(pose, vol_kind, size):
    width, height = size
    vol = jnp.asarray(_volume(vol_kind))
    u = _uniform(pose, width, height)
    got = np.asarray(mb.render_bonsai_kernel(vol, u, width=width,
                                             height=height, interpret=True))
    want = np.asarray(reference.render_bonsai(vol, u, width=width,
                                              height=height))
    assert got.shape == want.shape == (height, width, 4)
    assert np.isfinite(got).all()
    d = np.abs(got - want)
    assert d.mean() <= 1e-5, d.mean()
    assert (d.max(axis=-1) > 1e-3).mean() <= 1e-4, d.max()


@pytest.mark.parametrize("height,width", [(16, 16), (17, 33), (5, 3)])
def test_padding_is_masked(height, width):
    """Frames off the block grid are padded; the padding never leaks into
    the frame, which equals the same rays marched inside a larger,
    block-aligned frame."""
    vol = jnp.asarray(get_bonsai(32))
    u = _uniform("bench", 64, 64)
    eye, (dx, dy, dz) = geometry.rays_fragment_soa(u, 64, 64)
    full = mb.march_rays(vol, eye, (dx, dy, dz), 64, interpret=True)
    crop = mb.march_rays(vol, eye, tuple(c[:height, :width]
                                         for c in (dx, dy, dz)),
                         64, interpret=True)
    for c, f in zip(crop, full):
        assert c.shape == (height, width)
        np.testing.assert_array_equal(np.asarray(c),
                                      np.asarray(f)[:height, :width])


def test_pad_helper_shapes():
    x = jnp.zeros((5, 3), jnp.float32)
    p = mb._pad_to(x, 16, 16)
    assert p.shape == (16, 16)
    assert float(p[5:, :].min()) == 1.0 and float(p[:, 3:].min()) == 1.0
    assert mb._pad_to(p, 16, 16) is p


def test_kernel_rejects_float_volume():
    u = _uniform("bench", 16, 16)
    eye, dxyz = geometry.rays_fragment_soa(u, 16, 16)
    with pytest.raises(TypeError):
        mb.march_rays(jnp.zeros((8, 8, 8), jnp.float32), eye, dxyz,
                      interpret=True)


def test_max_steps_caps_the_march():
    """A step cap truncates the kernel exactly where it truncates the
    oracle."""
    vol = jnp.asarray(dense_stress(32))
    u = _uniform("bench", 32, 32)
    for steps in (1, 7):
        got = np.asarray(mb.render_bonsai_kernel(
            vol, u, width=32, height=32, max_steps=steps, interpret=True))
        want = np.asarray(reference.render_bonsai(
            vol, u, width=32, height=32, max_steps=steps))
        assert np.abs(got - want).max() < 1e-5


def test_linear_output_without_srgb():
    vol = jnp.asarray(get_bonsai(32))
    u = _uniform("bench", 32, 32)
    got = np.asarray(mb.render_bonsai_kernel(vol, u, width=32, height=32,
                                             srgb=False, interpret=True))
    want = np.asarray(reference.render_bonsai(vol, u, width=32, height=32,
                                              srgb=False))
    assert np.abs(got - want).max() < 1e-5
    assert (got[..., 3] == 1.0).all()


def test_vmapped_views_match_single_views():
    """The batched-views path (vmap over cameras) marches every view as the
    single-view call does."""
    from vokselis.parallel.sharding import orbit_camera_batch

    vol = jnp.asarray(get_bonsai(16))
    cams = orbit_camera_batch(3)
    batch = jax.vmap(lambda c: mb.render_bonsai_kernel(
        vol, c, width=16, height=16, max_steps=32, interpret=True))(cams)
    for k in range(3):
        one = mb.render_bonsai_kernel(vol, jax.tree.map(lambda x: x[k], cams),
                                      width=16, height=16, max_steps=32,
                                      interpret=True)
        np.testing.assert_allclose(np.asarray(batch[k]), np.asarray(one),
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# lowering for the GPU at real widths (no card needed)

_S = jax.ShapeDtypeStruct
_CAM = CameraUniform(_S((4,), jnp.float32), _S((4, 4), jnp.float32),
                     _S((4, 4), jnp.float32))


def _lowered_text(fn, *args, **kw):
    lowered = jax.jit(fn, static_argnames=tuple(kw)).trace(
        *args, **kw).lower(lowering_platforms=("cuda",))
    return lowered.as_text()


@pytest.mark.parametrize("dims,width,height", [
    (256, 1024, 1024),   # the flagship frame
    (256, 1920, 1080),   # the orbit at 1080p (not a block multiple)
    (256, 1280, 720),    # the demo's frame
    (512, 512, 512),     # config 5's volume and view size
    (48, 48, 40),        # a volume and frame off every power of two
])
def test_kernel_lowers_for_cuda(dims, width, height):
    txt = _lowered_text(mb.render_bonsai_kernel, _S((dims,) * 3, jnp.uint8),
                        _CAM, width=width, height=height)
    assert "bonsai_march" in txt
    assert "triton" in txt.lower()


def test_batched_views_lower_for_cuda():
    """64 views @512^2 of a 512^3 volume, vmapped into one launch."""
    cams = CameraUniform(_S((64, 4), jnp.float32), _S((64, 4, 4), jnp.float32),
                         _S((64, 4, 4), jnp.float32))

    def batch(vol, cams):
        return jax.vmap(lambda c: mb.render_bonsai_kernel(
            vol, c, width=512, height=512, max_steps=888))(cams)

    txt = _lowered_text(batch, _S((512,) * 3, jnp.uint8), cams)
    assert "bonsai_march" in txt


def test_row_band_lowers_for_cuda():
    """A quarter of a 1024^2 frame's rows: the row-sharded path's band."""
    planes = [_S((256, 1024), jnp.float32)] * 3

    def band(vol, eye, dx, dy, dz):
        return mb.render_bonsai_rays_kernel(vol, eye, (dx, dy, dz))

    txt = _lowered_text(band, _S((256,) * 3, jnp.uint8),
                        _S((3,), jnp.float32), *planes)
    assert "bonsai_march" in txt


# ---------------------------------------------------------------------------
# compiled on the card


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs this check on the card")


@pytest.mark.gpu
@pytest.mark.parametrize("pose", ["bench", "axis_aligned", "eye_inside"])
def test_compiled_kernel_matches_oracle(gpu, pose):
    vol = jnp.asarray(get_bonsai())
    u = _uniform(pose, 256, 256)
    got = np.asarray(mb.render_bonsai_kernel(vol, u, width=256, height=256))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(reference.render_bonsai(vol, u, width=256,
                                                  height=256))
    d = np.abs(got - want)
    assert d.mean() <= 1e-5
    assert (d.max(axis=-1) > 1e-3).mean() <= 1e-4
