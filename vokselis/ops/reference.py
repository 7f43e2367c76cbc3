"""Pure-jnp oracle renderers — exact ports of the reference's march semantics.

These are the correctness oracles for the Pallas march kernel and the CPU
mode. Everything is jittable; hot loops are ``lax.fori_loop`` with active
masks (the reference's per-pixel ``break`` at opacity 0.95,
shaders/raycast_naive.wgsl:115-117, becomes a ``done`` mask; the GPU kernel
exits per block instead).

Ports:
- :func:`render_bonsai` — shaders/raycast_naive.wgsl fs_main (:84-125),
  fragment-raymarch of an R8Unorm voxel grid, trilinear sampling,
  front-to-back compositing, quirks preserved:
  * ``clamp(vec3(0.4), vec3(0.9), val)`` passes 0.4 as the value and 0.9/val
    as the bounds, i.e. ``min(0.9, val)`` (:105);
  * sampling R8Unorm yields alpha 1, so ``pow(a, 2)`` is 1 and the
    background-bleed term (:112) vanishes;
  * per-ray ``dt = dt_scale * min(1/(256*|d|))`` — one voxel along the
    dominant axis per step (:97-99);
  * position accumulates ``p += dir*dt`` (:118), it is not recomputed from t.
- :func:`render_compute_tex` / :func:`render_compute_inline` —
  shaders/raycast_compute.wgsl ``render``/``get_col2`` (:60-131): nearest
  ``textureLoad`` of density + normal volumes, Lambert + directional + bottom
  fill lighting, clear-color ambient, initial alpha 0.1, dt effectively
  always 0.01. The ``_inline`` variant evaluates the procedural field at the
  quantized voxel coordinate instead of loading a precomputed texture —
  bitwise identical placement of samples, no gather and no precomputed
  volume.
- :func:`render_field` — framework-defined generic march over any density
  field evaluated at the exact (unquantized) sample position; used by the
  trig benchmark config.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from vokselis.core import geometry
from vokselis.core.colors import linear_to_srgb, smoothstep, mix, vertigo
from vokselis.volume.sample import sample_trilinear_r8, sample_nearest
from vokselis.volume import fields

# worst case: box diagonal sqrt(3) at dt = dt_scale/N (dominant axis = 1/sqrt(3)
# ... conservatively |d|max >= 1/sqrt(3) -> dt >= dt_scale/N)
MAX_STEPS_BONSAI = int(math.ceil(math.sqrt(3.0) * 256.0)) + 1  # 444
# [-1,1]^3 diagonal 2*sqrt(3) at dt = 0.01 (see module docstring)
MAX_STEPS_COMPUTE = int(math.ceil(2.0 * math.sqrt(3.0) / 0.01)) + 1  # 348

_BACKGROUND = (0.1, 0.2, 0.3, 0.01)  # raycast_naive.wgsl:88
_CLEAR_COLOR = (0.023, 0.02, 0.02, 0.0)  # raycast_compute.wgsl:119


def _bonsai_transfer(r):
    """raycast_naive.wgsl:101-108 for an R8Unorm sample ``r`` -> (rgb, alpha)."""
    v = jnp.minimum(0.9, r)  # the clamp-arg-order quirk (:105)
    v = smoothstep(0.10, 1.2, v)  # (:106)
    rgb = vertigo(v)
    return rgb, v


@partial(jax.jit, static_argnames=("width", "height", "max_steps", "dt_scale", "srgb"))
def render_bonsai(
    vol,
    camera_uniform,
    width: int = 1280,
    height: int = 720,
    max_steps: int = MAX_STEPS_BONSAI,
    dt_scale: float = 1.0,
    srgb: bool = True,
):
    """Fragment-path bonsai raymarch (raycast_naive.wgsl fs_main).

    ``vol``: (D, H, W) uint8 or float in [0,1]. Returns (height, width, 4) f32.
    Pixels whose ray misses the box return opaque black — identical to the
    pass clear color (wgpu::Color::BLACK, examples/bonsai/main.rs:40), so no
    rasterization-coverage emulation is needed.
    """
    eye, dirs = geometry.rays_fragment(camera_uniform, width, height)
    return render_bonsai_rays(vol, eye, dirs, max_steps=max_steps,
                              dt_scale=dt_scale, srgb=srgb)


def render_bonsai_rays(
    vol,
    eye,
    dirs,
    max_steps: int = MAX_STEPS_BONSAI,
    dt_scale: float = 1.0,
    srgb: bool = True,
):
    """March an arbitrary (H, W, 3) ray set with the bonsai semantics —
    the single implementation shared by :func:`render_bonsai` and the
    row-sharded multi-chip path (each chip marches its band of rays)."""
    height, width = dirs.shape[:2]
    npix = width * height
    d = dirs.reshape(npix, 3)
    eye_b = jnp.broadcast_to(eye, (npix, 3))

    t0, t1 = geometry.intersect_box_unit(eye_b, d)
    hit = t0 <= t1
    t_start = jnp.maximum(t0, 0.0)

    n = jnp.asarray(vol.shape[0], jnp.float32)  # shader hardcodes 256 (:97)
    dt_vec = 1.0 / (n * jnp.abs(d))
    dt = dt_scale * jnp.min(dt_vec, axis=-1)

    p0 = eye_b + t_start[:, None] * d

    def body(i, carry):
        p, rgb, a, t = carry
        active = hit & (t < t1) & (a < 0.95)
        r = sample_trilinear_r8(vol, p)
        c_rgb, c_a = _bonsai_transfer(r)
        # front-to-back under-compositing (:110-114); the background-bleed
        # term is identically zero for R8Unorm (val_alpha == 1)
        new_rgb = rgb + (1.0 - a)[:, None] * c_a[:, None] * c_rgb
        new_a = a + (1.0 - a) * c_a
        rgb = jnp.where(active[:, None], new_rgb, rgb)
        a = jnp.where(active, new_a, a)
        p = jnp.where(active[:, None], p + d * dt[:, None], p)
        t = jnp.where(active, t + dt, t)
        return (p, rgb, a, t)

    rgb0 = jnp.zeros((npix, 3), jnp.float32)
    a0 = jnp.zeros((npix,), jnp.float32)
    p, rgb, a, _ = lax.fori_loop(0, max_steps, body, (p0, rgb0, a0, t_start))

    rgb = jnp.where(hit[:, None], rgb, 0.0)
    if srgb:
        rgb = linear_to_srgb(rgb)
    out = jnp.concatenate([rgb, jnp.ones((npix, 1), jnp.float32)], axis=-1)
    return out.reshape(height, width, 4)


def _compute_shade(p, vol_rgba, normal_rgba, clear_color, color_rgb, color_a):
    """One step of get_col2's transfer + lighting + composite
    (raycast_compute.wgsl:69-95). Returns (new_rgb, new_a, step_alpha)."""
    normal = normal_rgba[..., :3]
    light = jnp.asarray([0.0, -1.0, 0.0], jnp.float32)
    shade = jnp.maximum(0.0, jnp.sum(light * normal, axis=-1))[..., None]
    shade = jnp.broadcast_to(shade, normal.shape)

    vol_color = vol_rgba[..., :3]
    vol_alpha = smoothstep(0.0, 0.7, jnp.power(vol_rgba[..., 3], 3.0))

    l_dir = jnp.asarray([-2.0, -2.0, -1.0], jnp.float32)
    l_dir = l_dir / jnp.linalg.norm(l_dir)
    directional = 3.0 * jnp.asarray([1.0, 0.1, 0.13], jnp.float32) * jnp.maximum(
        jnp.sum(normal * l_dir, axis=-1), 0.0
    )[..., None]
    mask_dir = jnp.asarray([1.0, 1.0, -1.0], jnp.float32)
    mask_dir = mask_dir / jnp.linalg.norm(mask_dir)
    directional = directional * smoothstep(
        0.3, 1.5, jnp.sum(p * mask_dir, axis=-1)
    )[..., None]
    vol_color = vol_color + directional

    bottom_light = 0.9 * jnp.clip(0.5 - 0.5 * normal[..., 1], 0.0, 1.0)
    blue = jnp.asarray([0.0, 0.0, 0.6], jnp.float32)
    shade = mix(shade, bottom_light[..., None] * blue, 0.2)

    clear_rgb = jnp.asarray(clear_color[:3], jnp.float32)
    clear_a = jnp.float32(clear_color[3])
    va = vol_alpha[..., None]
    new_rgb = color_rgb + (1.0 - color_a)[..., None] * va * vol_color * shade
    new_rgb = new_rgb + clear_rgb * clear_a * (1.0 - va)
    new_a = color_a + (1.0 - color_a) * vol_alpha * (1.0 - clear_a)
    return new_rgb, new_a


def _render_compute_core(
    lookup,
    camera_uniform,
    width,
    height,
    max_steps,
    block_size: float = 256.0,
    offset=(0.0, 0.0),
):
    """Shared body of the compute path (raycast_compute.wgsl render/get_col2).

    ``lookup(p)`` must return (vol_rgba, normal_rgba) for world positions p
    (..., 3) in [-1,1]^3.
    """
    eyes, dirs = geometry.rays_compute(
        camera_uniform, width, height, offset[0], offset[1]
    )
    npix = width * height
    d = dirs.reshape(npix, 3)
    eye = eyes.reshape(npix, 3)

    t0, t1 = geometry.intersect_box_sym(eye, d)
    hit = t0 < t1  # strict: reference tests t_hit.x < t_hit.y (:122)
    t_start = jnp.maximum(t0, 0.0)

    dt_vec = 1.0 / (block_size * jnp.abs(d))
    dt = jnp.maximum(jnp.min(dt_vec, axis=-1), 0.01)  # (:65-68)

    clear_rgb = jnp.asarray(_CLEAR_COLOR[:3], jnp.float32)
    # get_col2 initial color = (clear.rgb, 0.1) (:61)
    rgb0 = jnp.broadcast_to(clear_rgb, (npix, 3))
    a0 = jnp.full((npix,), 0.1, jnp.float32)

    def body(i, carry):
        rgb, a, t = carry
        active = hit & (t < t1) & (a < 0.95)
        p = eye + t[:, None] * d
        vol_rgba, normal_rgba = lookup(p)
        new_rgb, new_a = _compute_shade(p, vol_rgba, normal_rgba, _CLEAR_COLOR, rgb, a)
        rgb = jnp.where(active[:, None], new_rgb, rgb)
        a = jnp.where(active, new_a, a)
        t = jnp.where(active, t + dt, t)
        return (rgb, a, t)

    rgb, a, _ = lax.fori_loop(0, max_steps, body, (rgb0, a0, t_start))

    # render(): hit -> (marched rgb, 1); miss -> (clear rgb, 1) (:121-128)
    rgb = jnp.where(hit[:, None], rgb, clear_rgb)
    out = jnp.concatenate([rgb, jnp.ones((npix, 1), jnp.float32)], axis=-1)
    return out.reshape(height, width, 4)


@partial(jax.jit, static_argnames=("width", "height", "max_steps"))
def render_compute_tex(
    density_tex,
    normal_tex,
    camera_uniform,
    width: int = 1280,
    height: int = 720,
    max_steps: int = MAX_STEPS_COMPUTE,
):
    """Compute path with precomputed (D, H, W, 4) textures — the reference's
    exact structure (textureLoad at ivec3((p+1)*dims/2), :70-72)."""
    dims = density_tex.shape[0]

    def lookup(p):
        samp = ((p + 1.0) * (dims / 2.0)).astype(jnp.int32)
        return (
            sample_nearest(density_tex, samp).astype(jnp.float32),
            sample_nearest(normal_tex, samp).astype(jnp.float32),
        )

    return _render_compute_core(
        lookup, camera_uniform, width, height, max_steps, float(dims)
    )


@partial(jax.jit, static_argnames=("width", "height", "max_steps", "dims", "field"))
def render_compute_inline(
    camera_uniform,
    time=0.0,
    width: int = 1280,
    height: int = 720,
    max_steps: int = MAX_STEPS_COMPUTE,
    dims: int = 256,
    field=fields.noise_volume,
):
    """Compute path with the procedural field evaluated inline at the
    quantized voxel coordinate — samples land exactly where the texture
    variant's do, but with no precomputation and no gather."""
    time = jnp.asarray(time, jnp.float32)

    def lookup(p):
        samp = ((p + 1.0) * (dims / 2.0)).astype(jnp.int32)
        g = jnp.clip(samp, 0, dims - 1).astype(jnp.float32)
        coord = (g - dims / 2.0) / dims
        vol = field(coord, time)
        density = jnp.concatenate([vol[..., :3] / 2.0, vol[..., 3:4]], axis=-1)
        nrm = fields.gradient(coord, time, 1e-4)
        normal = jnp.concatenate(
            [nrm, jnp.linalg.norm(nrm, axis=-1, keepdims=True)], axis=-1
        )
        return density, normal

    return _render_compute_core(
        lookup, camera_uniform, width, height, max_steps, float(dims)
    )


@partial(
    jax.jit, static_argnames=("field", "width", "height", "max_steps", "block_size")
)
def render_field(
    camera_uniform,
    time=0.0,
    field=fields.trig_field,
    width: int = 512,
    height: int = 512,
    max_steps: int = MAX_STEPS_COMPUTE,
    block_size: float = 256.0,
):
    """Framework-defined: compute-path march with a continuous field sampled
    at the exact position (no voxel quantization) and emission-style shading
    (no normals). Used by the trig benchmark config (BASELINE.json config 1).
    """
    time = jnp.asarray(time, jnp.float32)
    clear_rgb = jnp.asarray(_CLEAR_COLOR[:3], jnp.float32)

    eyes, dirs = geometry.rays_compute(camera_uniform, width, height)
    npix = width * height
    d = dirs.reshape(npix, 3)
    eye = eyes.reshape(npix, 3)
    t0, t1 = geometry.intersect_box_sym(eye, d)
    hit = t0 < t1
    t_start = jnp.maximum(t0, 0.0)
    dt_vec = 1.0 / (block_size * jnp.abs(d))
    dt = jnp.maximum(jnp.min(dt_vec, axis=-1), 0.01)

    rgb0 = jnp.broadcast_to(clear_rgb, (npix, 3))
    a0 = jnp.full((npix,), 0.1, jnp.float32)

    def body(i, carry):
        rgb, a, t = carry
        active = hit & (t < t1) & (a < 0.95)
        p = eye + t[:, None] * d
        v = field(p, time)
        vol_alpha = smoothstep(0.0, 0.7, jnp.power(v[..., 3], 3.0))
        va = vol_alpha[..., None]
        new_rgb = rgb + (1.0 - a)[..., None] * va * v[..., :3]
        new_a = a + (1.0 - a) * vol_alpha
        rgb = jnp.where(active[:, None], new_rgb, rgb)
        a = jnp.where(active, new_a, a)
        t = jnp.where(active, t + dt, t)
        return (rgb, a, t)

    rgb, a, _ = lax.fori_loop(0, max_steps, body, (rgb0, a0, t_start))
    rgb = jnp.where(hit[:, None], rgb, clear_rgb)
    out = jnp.concatenate([rgb, jnp.ones((npix, 1), jnp.float32)], axis=-1)
    return out.reshape(height, width, 4)
