"""Bonsai raymarch kernel for NVIDIA GPUs (Pallas, Triton route).

One program marches one ``BLOCK_H x BLOCK_W`` block of pixels, one ray per
lane, with the reference's own design (shaders/raycast_naive.wgsl fs_main):
the carry (p, rgb, alpha, t) stays in registers, each step reads its eight
trilinear taps straight from the flat uint8 volume (256^3 is 16 MiB, so the
volume stays resident in the card's L2), and the block leaves its loop as
soon as every ray in it is done (``t >= t1`` or ``alpha >= 0.95``).

The arithmetic is :func:`vokselis.ops.reference.render_bonsai_rays` step for
step -- the same slab test, ``dt``, accumulated position ``p += d*dt``,
clamp-to-edge trilinear taps (:mod:`vokselis.volume.sample`), transfer and
front-to-back compositing -- so the two agree to f32 rounding. sRGB encoding
and the alpha plane are applied by XLA after the kernel.

The ray set arrives as SoA planes (``geometry.rays_fragment_soa``), so the
row-sharded multi-device path can hand each device its band of rows.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from vokselis.core import geometry
from vokselis.core.colors import bonsai_transfer_soa, linear_to_srgb
from vokselis.ops.reference import MAX_STEPS_BONSAI

BLOCK_H = 4
BLOCK_W = 8
NUM_WARPS = 1


def _march_kernel(eye_ref, dx_ref, dy_ref, dz_ref, vol_ref,
                  r_ref, g_ref, b_ref, *, dims, height, width, max_steps):
    depth, rows, cols = dims
    block_h, block_w = dx_ref.shape
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    ex, ey, ez = eye_ref[0], eye_ref[1], eye_ref[2]

    # pixels of the padding around a frame that is not a block multiple
    row = pl.program_id(0) * block_h + lax.broadcasted_iota(
        jnp.int32, (block_h, block_w), 0)
    col = pl.program_id(1) * block_w + lax.broadcasted_iota(
        jnp.int32, (block_h, block_w), 1)
    inside = (row < height) & (col < width)

    # slab test against [0,1]^3 (geometry.intersect_box_unit)
    ix, iy, iz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    ax0, ax1 = (0.0 - ex) * ix, (1.0 - ex) * ix
    ay0, ay1 = (0.0 - ey) * iy, (1.0 - ey) * iy
    az0, az1 = (0.0 - ez) * iz, (1.0 - ez) * iz
    t0 = jnp.maximum(jnp.maximum(jnp.minimum(ax0, ax1), jnp.minimum(ay0, ay1)),
                     jnp.minimum(az0, az1))
    t1 = jnp.minimum(jnp.minimum(jnp.maximum(ax0, ax1), jnp.maximum(ay0, ay1)),
                     jnp.maximum(az0, az1))
    hit = (t0 <= t1) & inside
    t_start = jnp.maximum(t0, 0.0)

    # one voxel along the dominant axis per step (raycast_naive.wgsl:97-99)
    n = float(depth)
    dt = 1.0 / (n * jnp.abs(dx))
    dt = jnp.minimum(dt, 1.0 / (n * jnp.abs(dy)))
    dt = jnp.minimum(dt, 1.0 / (n * jnp.abs(dz)))

    def tap(xi, yi, zi):
        xi = jnp.clip(xi, 0, cols - 1)
        yi = jnp.clip(yi, 0, rows - 1)
        zi = jnp.clip(zi, 0, depth - 1)
        v = vol_ref[(zi * rows + yi) * cols + xi]
        return v.astype(jnp.float32) * (1.0 / 255.0)

    def sample(px, py, pz):
        # volume.sample.sample_trilinear_r8: half-texel centers, clamp to edge
        x = px * float(cols) - 0.5
        y = py * float(rows) - 0.5
        z = pz * float(depth) - 0.5
        xf, yf, zf = jnp.floor(x), jnp.floor(y), jnp.floor(z)
        fx, fy, fz = x - xf, y - yf, z - zf
        x0, y0, z0 = (xf.astype(jnp.int32), yf.astype(jnp.int32),
                      zf.astype(jnp.int32))
        c000 = tap(x0, y0, z0)
        c100 = tap(x0 + 1, y0, z0)
        c010 = tap(x0, y0 + 1, z0)
        c110 = tap(x0 + 1, y0 + 1, z0)
        c001 = tap(x0, y0, z0 + 1)
        c101 = tap(x0 + 1, y0, z0 + 1)
        c011 = tap(x0, y0 + 1, z0 + 1)
        c111 = tap(x0 + 1, y0 + 1, z0 + 1)
        c00 = c000 + (c100 - c000) * fx
        c10 = c010 + (c110 - c010) * fx
        c01 = c001 + (c101 - c001) * fx
        c11 = c011 + (c111 - c011) * fx
        c0 = c00 + (c10 - c00) * fy
        c1 = c01 + (c11 - c01) * fy
        return c0 + (c1 - c0) * fz

    def live(a, t):
        return hit & (t < t1) & (a < 0.95)

    def cond(carry):
        i, a, t = carry[0], carry[7], carry[8]
        # a max over int32 (Triton has no lowering for a boolean any),
        # taken here: carrying a reduced scalar through the loop crashes
        # the Triton compiler
        return (i < max_steps) & (jnp.max(live(a, t).astype(jnp.int32)) > 0)

    def body(carry):
        i, px, py, pz, r, g, b, a, t = carry
        active = live(a, t)
        tv, cr, cg, cb = bonsai_transfer_soa(sample(px, py, pz))
        # front-to-back under-compositing (raycast_naive.wgsl:110-114)
        w = (1.0 - a) * tv
        r = jnp.where(active, r + w * cr, r)
        g = jnp.where(active, g + w * cg, g)
        b = jnp.where(active, b + w * cb, b)
        a = jnp.where(active, a + w, a)
        px = jnp.where(active, px + dx * dt, px)
        py = jnp.where(active, py + dy * dt, py)
        pz = jnp.where(active, pz + dz * dt, pz)
        t = jnp.where(active, t + dt, t)
        return (i + 1, px, py, pz, r, g, b, a, t)

    zeros = jnp.zeros((block_h, block_w), jnp.float32)
    init = (jnp.int32(0),
            ex + t_start * dx, ey + t_start * dy, ez + t_start * dz,
            zeros, zeros, zeros, zeros, t_start)
    out = lax.while_loop(cond, body, init)
    r, g, b = out[4], out[5], out[6]
    r_ref[...] = jnp.where(hit, r, 0.0)
    g_ref[...] = jnp.where(hit, g, 0.0)
    b_ref[...] = jnp.where(hit, b, 0.0)


def _pad_to(x, ph, pw):
    h, w = x.shape
    if (h, w) == (ph, pw):
        return x
    # the padding's rays are masked off in the kernel; 1.0 keeps their
    # slab arithmetic finite
    return jnp.pad(x, ((0, ph - h), (0, pw - w)), constant_values=1.0)


def march_rays(vol_u8, eye, dxyz, max_steps: int = MAX_STEPS_BONSAI, *,
               interpret: bool = False):
    """March a ray set; returns the linear (r, g, b) planes, each (H, W).

    ``vol_u8``: (D, H, W) uint8. ``eye``: (3,). ``dxyz``: three (H, W)
    planes of normalized directions. Frames that are not a multiple of the
    block are padded and the padding is masked in the kernel. The block
    (4x8 pixels, one warp) was the fastest of the shapes timed on an H100
    at 1024^2 (PERF.md).
    """
    if vol_u8.dtype != jnp.uint8:
        raise TypeError(
            f"the march kernel reads uint8 volumes, got {vol_u8.dtype}")
    dx, dy, dz = dxyz
    height, width = dx.shape
    ph = pl.cdiv(height, BLOCK_H) * BLOCK_H
    pw = pl.cdiv(width, BLOCK_W) * BLOCK_W
    planes = [_pad_to(jnp.asarray(c, jnp.float32), ph, pw)
              for c in (dx, dy, dz)]
    flat = vol_u8.reshape(-1)
    kernel = functools.partial(
        _march_kernel, dims=tuple(vol_u8.shape), height=height, width=width,
        max_steps=int(max_steps))
    pix = pl.BlockSpec((BLOCK_H, BLOCK_W), lambda i, j: (i, j))
    out = pl.pallas_call(
        kernel,
        grid=(ph // BLOCK_H, pw // BLOCK_W),
        in_specs=[
            pl.BlockSpec((3,), lambda i, j: (0,)),
            pix, pix, pix,
            pl.BlockSpec(flat.shape, lambda i, j: (0,)),
        ],
        out_specs=[pix, pix, pix],
        out_shape=[jax.ShapeDtypeStruct((ph, pw), jnp.float32)] * 3,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="bonsai_march",
    )(jnp.asarray(eye, jnp.float32).reshape(3), *planes, flat)
    return tuple(c[:height, :width] for c in out)


def render_bonsai_rays_kernel(vol_u8, eye, dxyz,
                              max_steps: int = MAX_STEPS_BONSAI,
                              srgb: bool = True, interpret: bool = False):
    """The kernel's counterpart of ``reference.render_bonsai_rays`` with SoA
    directions: returns the (H, W, 4) frame, sRGB-encoded when ``srgb``."""
    r, g, b = march_rays(vol_u8, eye, dxyz, max_steps, interpret=interpret)
    rgb = jnp.stack([r, g, b], axis=-1)
    if srgb:
        rgb = linear_to_srgb(rgb)
    alpha = jnp.ones(rgb.shape[:-1] + (1,), jnp.float32)
    return jnp.concatenate([rgb, alpha], axis=-1)


@functools.partial(jax.jit, static_argnames=(
    "width", "height", "max_steps", "srgb", "interpret"))
def render_bonsai_kernel(vol_u8, camera_uniform, width: int = 1280,
                         height: int = 720, max_steps: int = MAX_STEPS_BONSAI,
                         srgb: bool = True, interpret: bool = False):
    """Whole-frame bonsai render through the kernel (the counterpart of
    ``reference.render_bonsai``)."""
    eye, dxyz = geometry.rays_fragment_soa(camera_uniform, width, height)
    return render_bonsai_rays_kernel(vol_u8, eye, dxyz, max_steps, srgb,
                                     interpret=interpret)
