"""Multi-device sharding tests on the 8-device virtual CPU mesh
(SURVEY.md §4 point 4 / §2d). The march kernel runs in interpret mode where
a test drives it; everything else uses the CPU's dispatch (the oracle)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vokselis.core.camera import Camera
from vokselis.ops import backend
from vokselis.ops.pallas import march_bonsai as mb
from vokselis.parallel.sharding import (
    build_ray_renderer,
    make_mesh,
    multi_view_step,
    orbit_camera_batch,
    render_frame_tiled,
    render_views_sharded,
)
from vokselis.volume.io import get_bonsai


@pytest.fixture(autouse=True)
def eight_devices():
    if jax.device_count() < 8:
        pytest.skip("needs 8 (virtual) devices")


def _vol():
    return jnp.asarray(get_bonsai(16))


class TestSharding:
    def test_view_sharded_matches_single_device(self):
        """Sharded-vs-single parity THROUGH the (render, pack) API — the
        same functional pair drives the march kernel on GPUs."""
        mesh = make_mesh(views=8, tiles=1)
        vol = _vol()
        cams = orbit_camera_batch(8)
        render, pack = backend.build_renderer(vol)
        out = render_views_sharded(mesh, render, pack, cams, 16, 16,
                                   max_steps=8)
        out = np.asarray(out)
        assert out.shape == (8, 16, 16, 4)
        # every view must match an unsharded render through the same pair
        for k in (0, 3, 7):
            one = jax.tree.map(lambda x: x[k], cams)
            ref = np.asarray(render(pack, one, 16, 16, 8))
            np.testing.assert_allclose(out[k], ref, atol=1e-5)

    def test_gathered_replication(self):
        mesh = make_mesh(views=4, tiles=2)
        out = multi_view_step(mesh, _vol(), n_views=8, width=16, height=16,
                              max_steps=4, gather=True)
        assert np.asarray(out).shape == (8, 16, 16, 4)
        assert np.isfinite(np.asarray(out)).all()

    def test_tile_sharded_frame_matches(self):
        mesh = make_mesh(views=4, tiles=2)
        vol = _vol()
        cam = Camera.bonsai(1.0).uniform()
        img = np.asarray(
            render_frame_tiled(mesh, vol, cam, width=16, height=16, max_steps=8)
        )
        from vokselis.ops.reference import render_bonsai

        ref = np.asarray(render_bonsai(vol, cam, width=16, height=16, max_steps=8))
        np.testing.assert_allclose(img, ref, atol=1e-5)

    @pytest.mark.parametrize("tiles", [2, 4, 8])
    def test_tile_sharded_frame_pallas_kernel(self, tiles):
        """The row-sharded path drives the march kernel (interpret mode on
        the CPU mesh): each device marches its band of rows, and the
        gathered frame matches the oracle."""
        vol = get_bonsai(16)
        cam = Camera.bonsai(1.0).uniform()
        mesh = make_mesh(views=8 // tiles, tiles=tiles)
        renderer = build_ray_renderer(vol, rays_fn=functools.partial(
            mb.render_bonsai_rays_kernel, interpret=True))
        img = np.asarray(
            render_frame_tiled(mesh, None, cam, width=32, height=32,
                               max_steps=16, renderer=renderer)
        )
        from vokselis.ops.reference import render_bonsai

        ref = np.asarray(
            render_bonsai(jnp.asarray(vol), cam, width=32, height=32,
                          max_steps=16)
        )
        assert img.shape == (32, 32, 4)
        assert np.abs(img - ref).max() < 1e-5

    @pytest.mark.parametrize("views", [8, 4])
    def test_view_sharded_pallas_kernel(self, views):
        """The view-sharded path with the march kernel (interpret mode)
        matches the same kernel on one device, view by view."""
        mesh = make_mesh(views=views, tiles=8 // views)
        vol = _vol()
        cams = orbit_camera_batch(8)

        def render(pk, cam, width, height, max_steps):
            return mb.render_bonsai_kernel(pk, cam, width=width,
                                           height=height,
                                           max_steps=max_steps,
                                           interpret=True)

        out = np.asarray(render_views_sharded(mesh, render, vol, cams, 16,
                                              16, max_steps=8, gather=True))
        assert out.shape == (8, 16, 16, 4)
        for k in range(8):
            one = np.asarray(render(vol, jax.tree.map(lambda x: x[k], cams),
                                    16, 16, 8))
            np.testing.assert_allclose(out[k], one, atol=1e-6)

    def test_graft_dryrun(self):
        import __graft_entry__ as ge

        ge.dryrun_multichip(8)

    def test_graft_entry_compiles(self):
        import __graft_entry__ as ge

        fn, args = ge.entry()
        out = np.asarray(jax.jit(fn)(*args))
        assert out.shape[-1] == 4
        assert np.isfinite(out).all()
