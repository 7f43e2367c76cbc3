"""Device-mesh sharding for batched multi-view and tiled rendering.

The reference is strictly single-GPU (SURVEY.md §2d); its only parallelism
constructs are workgroup grids and the framebuffer tile decomposition
(examples/xor/main.rs:77-118). The scale-out maps:

- BASELINE.json config 5 (batched 64-view rendering) -> data parallelism
  over a 'views' mesh axis via shard_map: each device renders its views with
  the unchanged single-device renderer; an optional all_gather assembles
  the frames on every device;
- image-space tile sharding (the 'tile mode' ancestor) -> splitting frame
  ROWS over a 'tiles' axis: rays are independent, so no halo exchange is
  needed; the gather of the bands is the only collective;
- volumes too large for one device would shard bricks -- not needed for any
  reference config (256^3 = 16 MiB).

Renderers are passed as ``(render, pack)`` pairs
(:func:`vokselis.ops.backend.build_renderer`); the pack (the uint8 volume)
is a REPLICATED argument of shard_map, so the same code drives the march
kernel on GPUs and the jnp oracle on CPU meshes. The mesh follows the
algorithm alone: the GPUs of one host reach each other at the same rate.

Everything here runs on the 8-device virtual CPU mesh the tests use
(XLA_FLAGS=--xla_force_host_platform_device_count=8) and on GPUs.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vokselis.core.camera import Camera, CameraUniform
from vokselis.ops import backend


def shard_map(f, mesh, in_specs, out_specs):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def make_mesh(views: int | None = None, tiles: int = 1, devices=None) -> Mesh:
    """Build a (views, tiles) mesh; views defaults to n_devices/tiles."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if views is None:
        views = n // tiles
    assert views * tiles == n, f"{views}x{tiles} != {n} devices"
    arr = np.asarray(devices).reshape(views, tiles)
    return Mesh(arr, ("views", "tiles"))


def orbit_camera_batch(n_views: int, target=(0.5, 0.5, 0.5), zoom=1.0,
                       pitch=0.5, aspect=1.0) -> CameraUniform:
    """N cameras orbiting the target in yaw — BASELINE config 5's batched
    views (and config 4's orbiting camera, sampled at n frames). Returns a
    CameraUniform pytree with a leading (n_views,) batch axis."""
    uniforms = []
    for i in range(n_views):
        cam = Camera(zoom=zoom, pitch=pitch, yaw=2.0 * math.pi * i / n_views,
                     target=target, aspect=aspect)
        uniforms.append(cam.uniform())
    return jax.tree.map(lambda *xs: jnp.stack(xs), *uniforms)


def render_views_sharded(
    mesh: Mesh,
    render,
    pack,
    cams: CameraUniform,  # leading (n_views,) batch axis
    width: int,
    height: int,
    max_steps: int = 64,
    gather: bool = False,
):
    """Render a batch of views, sharded over the mesh's 'views' axis.

    ``(render, pack)``: a functional renderer pair
    (``backend.build_renderer``). The pack is replicated (the 256^3 uint8
    volume is 16 MiB); cameras are split. With ``gather=True`` every device
    receives all frames via all_gather (SURVEY.md §2d); otherwise the
    output stays view-sharded for per-shard host egress.
    """

    fn = _views_sharded_fn(
        mesh, render, width, height, max_steps, gather,
        jax.tree.structure(pack), jax.tree.structure(cams),
    )
    return fn(pack, cams)


@functools.lru_cache(maxsize=64)
def _views_sharded_fn(mesh, render, width, height, max_steps, gather,
                      pack_def, cam_def):
    """One jitted shard-mapped callable per (mesh, renderer, shape) config:
    wrapping jax.jit around a fresh closure on every render_views_sharded
    call would re-trace every frame (jit caches by function identity)."""

    def local_step(pack_l, cams_l):
        imgs = jax.vmap(
            lambda c: render(pack_l, c, width, height, max_steps)
        )(cams_l)
        if gather:
            imgs = jax.lax.all_gather(imgs, "views", axis=0, tiled=True)
        return imgs

    pack_spec = jax.tree.unflatten(pack_def, [P()] * pack_def.num_leaves)
    cam_spec = jax.tree.unflatten(cam_def, [P("views")] * cam_def.num_leaves)
    out_spec = P() if gather else P("views")
    return jax.jit(shard_map(local_step, mesh, (pack_spec, cam_spec),
                             out_spec))


def build_ray_renderer(vol_u8, rays_fn=None):
    """``(render_rays, pack)`` pair with the ray-set signature
    ``render_rays(pack, eye, (dx, dy, dz), max_steps)`` -> (H, W, 4): what
    the row-sharded single-frame path marches each device's band with.
    ``rays_fn`` defaults to the platform's march
    (``backend.bonsai_rays_fn``)."""
    rays_fn = backend.bonsai_rays_fn() if rays_fn is None else rays_fn
    pack = jnp.asarray(vol_u8, jnp.uint8)

    def render_rays(pk, eye, dxyz, max_steps=backend.MAX_STEPS_BONSAI):
        return rays_fn(pk, eye, dxyz, max_steps)

    return render_rays, pack


def render_frame_tiled(
    mesh: Mesh,
    vol,
    cam: CameraUniform,
    width: int,
    height: int,
    max_steps: int = 64,
    renderer=None,
):
    """Render ONE frame with its rows sharded over the 'tiles' axis — the
    multi-device descendant of the xor demo's 256^2-tile dispatch
    (examples/xor/main.rs:235-254). Rays are independent: the full-frame ray
    set is generated inside the same program (replicated camera math, the
    same fused arithmetic as a one-device frame), its ROWS are sharded over
    the mesh, and each device marches its band through the shared ray-set
    entry point (``build_ray_renderer``). The final all_gather assembles the
    frame on every device.

    ``renderer``: optional ``(render_rays, pack)`` pair from
    :func:`build_ray_renderer`; ``vol`` is ignored when given. Pass a
    stable pair to reuse the compiled step across calls."""
    n_tiles = mesh.shape["tiles"]
    assert height % n_tiles == 0, (height, n_tiles)

    render_rays, pack = (
        renderer if renderer is not None else build_ray_renderer(vol)
    )
    return _frame_tiled_fn(mesh, render_rays, width, height, max_steps)(
        pack, cam)


@functools.lru_cache(maxsize=64)
def _frame_tiled_fn(mesh, render_rays, width, height, max_steps):
    """Cached jitted row-sharded frame step (see _views_sharded_fn)."""
    from vokselis.core import geometry

    def local_step(pack_l, eye_l, dx_l, dy_l, dz_l):
        img = render_rays(pack_l, eye_l, (dx_l, dy_l, dz_l),
                          max_steps=max_steps)
        return jax.lax.all_gather(img, "tiles", axis=0, tiled=True)

    row_spec = P("tiles")
    step = shard_map(local_step, mesh,
                     (P(), P(), row_spec, row_spec, row_spec), P())

    def frame(pack, cam):
        eye, (dx, dy, dz) = geometry.rays_fragment_soa(cam, width, height)
        return step(pack, eye, dx, dy, dz)

    return jax.jit(frame)


def multi_view_step(mesh: Mesh, vol, n_views: int, width: int, height: int,
                    max_steps: int = 32, gather: bool = True, renderer=None):
    """The full multi-device 'step': batched orbit cameras -> sharded render
    -> gathered frames. ``renderer``: optional (render, pack) pair; defaults
    to the platform's (``backend.build_renderer``)."""
    render, pack = renderer if renderer is not None else backend.build_renderer(vol)
    cams = orbit_camera_batch(n_views)
    cams = jax.device_put(
        cams,
        jax.tree.map(lambda _: NamedSharding(mesh, P("views")), cams),
    )
    return render_views_sharded(
        mesh, render, pack, cams, width, height, max_steps=max_steps,
        gather=gather,
    )
