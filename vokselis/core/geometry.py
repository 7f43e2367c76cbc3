"""Ray generation and ray-AABB intersection (pure jnp, shape-polymorphic).

Reference sources:
- slab test vs [0,1]^3: shaders/raycast_naive.wgsl:50-61
- slab test vs [-1,1]^3: shaders/raycast_compute.wgsl:42-53
- fragment-path ray gen (perspective-correct interpolation of cube-surface
  position minus eye — equivalent to unprojecting through pixel centers):
  shaders/raycast_naive.wgsl:40-48
- compute-path ray gen with the reference's ``screen.y *= -aspect`` quirk:
  shaders/raycast_compute.wgsl:99-117
"""

from __future__ import annotations

import jax.numpy as jnp


def intersect_box(orig, direction, box_min, box_max):
    """Slab test. Returns (t0, t1); hit iff t0 <= t1 (reference tests t0 > t1
    as the miss condition). ``orig``/``direction``: (..., 3)."""
    inv_dir = 1.0 / direction
    tmin_tmp = (box_min - orig) * inv_dir
    tmax_tmp = (box_max - orig) * inv_dir
    tmin = jnp.minimum(tmin_tmp, tmax_tmp)
    tmax = jnp.maximum(tmin_tmp, tmax_tmp)
    t0 = jnp.max(tmin, axis=-1)
    t1 = jnp.min(tmax, axis=-1)
    return t0, t1


def intersect_box_unit(orig, direction):
    """[0,1]^3 box (bonsai path, shaders/raycast_naive.wgsl:50-61)."""
    return intersect_box(orig, direction, 0.0, 1.0)


def intersect_box_sym(orig, direction):
    """[-1,1]^3 box (compute path, shaders/raycast_compute.wgsl:42-53)."""
    return intersect_box(orig, direction, -1.0, 1.0)


def pixel_centers(width: int, height: int, dtype=jnp.float32):
    """Framebuffer-space coordinates of pixel centers: (H, W) each of x, y."""
    xs = (jnp.arange(width, dtype=dtype) + 0.5)[None, :]
    ys = (jnp.arange(height, dtype=dtype) + 0.5)[:, None]
    x = jnp.broadcast_to(xs, (height, width))
    y = jnp.broadcast_to(ys, (height, width))
    return x, y


def mat4_apply(m, x, y, z, w=1.0):
    """Apply a row-major 4x4 to a homogeneous point with explicit f32
    arithmetic (NOT a matmul: on a GPU a float32 matmul may run in TF32,
    which keeps about three decimal digits and destroys the tiny clip-space
    w of far-plane points; elementwise math is exact and cheap for
    4-vectors).

    Returns four arrays (X, Y, Z, W) broadcast over the inputs.
    """
    out = []
    for i in range(4):
        out.append(m[i, 0] * x + m[i, 1] * y + m[i, 2] * z + m[i, 3] * w)
    return out


def unproject(inv_proj, ndc_x, ndc_y, ndc_z):
    """Apply the inverse proj*view matrix to an NDC point, divide by w.

    ``ndc_*`` broadcastable arrays; returns (..., 3) world-space points.
    """
    x, y, z, w = mat4_apply(inv_proj, ndc_x, ndc_y, jnp.asarray(ndc_z, jnp.float32))
    return jnp.stack([x / w, y / w, z / w], axis=-1)


def rays_fragment(camera_uniform, width: int, height: int):
    """Bonsai-style rays: one per pixel center, through the camera.

    The reference rasterizes the unit cube and interpolates
    ``ray_dir = surface_pos - eye`` perspective-correct across the fragment
    (shaders/raycast_naive.wgsl:40-48), which is exactly the ray through the
    pixel center. wgpu NDC: x right in [-1,1], y up in [-1,1]; pixel (i, j)
    center maps to ndc (2*(i+.5)/W - 1, 1 - 2*(j+.5)/H).

    Returns (eye (3,), dirs (H, W, 3) normalized) -- the stacked form of
    :func:`rays_fragment_soa`, so the oracle and the march kernel see
    bit-identical rays.
    """
    eye, (dx, dy, dz) = rays_fragment_soa(camera_uniform, width, height)
    return eye, jnp.stack([dx, dy, dz], axis=-1)


def rays_fragment_soa(camera_uniform, width: int, height: int):
    """Fragment-path rays as SoA planes: returns (eye (3,), (dx, dy, dz)
    each (H, W)). Projective depths 0 (near) and 1 (far) in wgpu; the ray
    direction is their unprojected difference."""
    px, py = pixel_centers(width, height)
    ndc_x = 2.0 * px / width - 1.0
    ndc_y = 1.0 - 2.0 * py / height
    inv = camera_uniform.inv_proj
    nx, ny, nz, nw = mat4_apply(inv, ndc_x, ndc_y, jnp.float32(0.0))
    fx, fy, fz, fw = mat4_apply(inv, ndc_x, ndc_y, jnp.float32(1.0))
    dx = fx / fw - nx / nw
    dy = fy / fw - ny / nw
    dz = fz / fw - nz / nw
    inv_len = 1.0 / jnp.sqrt(dx * dx + dy * dy + dz * dz)
    return camera_uniform.view_position[:3], (dx * inv_len, dy * inv_len, dz * inv_len)


def rays_compute(camera_uniform, width: int, height: int, offset_x=0.0, offset_y=0.0):
    """Compute-path rays, replicating shaders/raycast_compute.wgsl:99-117
    verbatim, including the ``screen.y *= -aspect_ratio`` quirk
    (aspect_ratio = H/W) and the screen-point/tangent-point unprojection.

    Returns (eyes (H, W, 3), dirs (H, W, 3)); note the compute path derives a
    per-pixel eye from unprojection (they all coincide up to fp error).
    """
    px, py = pixel_centers(width, height)
    # reference uses integer gid + offset, not pixel centers: coord = gid + offset
    coord_x = px - 0.5 + offset_x
    coord_y = py - 0.5 + offset_y
    aspect_ratio = float(height) / float(width)
    sx = 2.0 * coord_x / width - 1.0
    sy = (2.0 * coord_y / height - 1.0) * (-aspect_ratio)
    eye = unproject(camera_uniform.inv_proj, sx, sy, 0.0)
    tang = unproject(camera_uniform.inv_proj, sx, sy, 1.0)
    d = tang - eye
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return eye, d
