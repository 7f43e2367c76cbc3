"""Procedural density fields (jitted JAX density functions).

Replicates shaders/xor.wgsl verbatim: ``hash`` (:3-5), value ``noise``
(:7-22), 3-octave ``fbm`` (:24-33), the animated ``noise_volume`` field
(:55-61), the bitwise ``xor`` field (:46-53, unused by the reference demo but
kept for parity), and central-difference ``gradient`` normals (:63-67).

All functions take ``coord`` of shape (..., 3) and are elementwise jnp — they
run equally under jit and vmap, and the compute-path oracle evaluates them
inline during the march instead of loading the reference's precomputed
rgba16float 3D storage textures.

``trig_field`` is framework-defined (no reference analog): BASELINE.json
config 1 calls for a "procedural trig density field" benchmark; the reference
trig demo is a rasterized triangle (examples/trig.rs), reproduced separately
in vokselis.models.trig.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from vokselis.core.colors import fract, mix, smoothstep


def hash_(h):
    """fract(sin(h) * 43758.5453123) — shaders/xor.wgsl:18-20."""
    return fract(jnp.sin(h) * 43758.5453123)


def noise(x):
    """Value noise on a 157/113 lattice — shaders/xor.wgsl:22-35.

    ``x``: (..., 3); returns (...,).
    """
    p = jnp.floor(x)
    f = fract(x)
    f = f * f * (3.0 - 2.0 * f)
    n = p[..., 0] + p[..., 1] * 157.0 + 113.0 * p[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return mix(
        mix(
            mix(hash_(n + 0.0), hash_(n + 1.0), fx),
            mix(hash_(n + 157.0), hash_(n + 158.0), fx),
            fy,
        ),
        mix(
            mix(hash_(n + 113.0), hash_(n + 114.0), fx),
            mix(hash_(n + 270.0), hash_(n + 271.0), fx),
            fy,
        ),
        fz,
    )


def fbm(p):
    """3-octave fbm — shaders/xor.wgsl:37-44."""
    f = 0.5000 * noise(p)
    p = p * 2.01
    f = f + 0.2500 * noise(p)
    p = p * 2.02
    f = f + 0.1250 * noise(p)
    return f


def _animated_pos(coord, time):
    """shaders/xor.wgsl:57 — pos = (coord + (1, 0.1*sin t, 21)) * 32."""
    shift = jnp.stack(
        [
            jnp.ones_like(time),
            jnp.sin(time * 1.0) * 0.1,
            jnp.full_like(time, 21.0),
        ],
        axis=-1,
    )
    return (coord + shift) * 32.0


def xor_field(coord, time=0.0):
    """The bitwise x&y&z field — shaders/xor.wgsl:46-53. Returns (..., 4)."""
    time = jnp.asarray(time, jnp.float32)
    pos = _animated_pos(coord, time)
    res = 25.0
    q = (pos * res).astype(jnp.int32)
    val = (q[..., 0] & q[..., 1] & q[..., 2]).astype(jnp.float32) / res
    alpha = val * smoothstep(0.7, 0.0, jnp.linalg.norm(coord, axis=-1))
    return jnp.stack([val, val, val, alpha], axis=-1)


def noise_volume(coord, time=0.0):
    """The fbm field actually rendered by the xor demo — shaders/xor.wgsl:55-61.

    Returns (..., 4) = (val, val, val, alpha)."""
    time = jnp.asarray(time, jnp.float32)
    pos = _animated_pos(coord, time)
    val = fbm(pos)
    alpha = val * smoothstep(0.5, 0.25, jnp.linalg.norm(coord, axis=-1))
    return jnp.stack([val, val, val, alpha], axis=-1)


def gradient(coord, time=0.0, eps: float = 1e-4):
    """Central... actually one-sided difference normal of ``noise_volume``'s
    alpha — shaders/xor.wgsl:63-67 (forward point minus backward-offset
    points, normalized)."""
    a0 = noise_volume(coord, time)[..., 3]
    ex = jnp.asarray([eps, 0.0, 0.0], jnp.float32)
    ey = jnp.asarray([0.0, eps, 0.0], jnp.float32)
    ez = jnp.asarray([0.0, 0.0, eps], jnp.float32)
    ax = noise_volume(coord - ex, time)[..., 3]
    ay = noise_volume(coord - ey, time)[..., 3]
    az = noise_volume(coord - ez, time)[..., 3]
    g = jnp.stack([a0 - ax, a0 - ay, a0 - az], axis=-1)
    n = jnp.linalg.norm(g, axis=-1, keepdims=True)
    return g / jnp.maximum(n, 1e-20)


def generate_xor_volumes(dims: int = 256, time=0.0):
    """The reference's one-time volume-generation dispatch
    (shaders/xor.wgsl:69-78 via examples/xor/main.rs:135-146): fills two
    (D, H, W, 4) float32 arrays — the density texture ``(vol.rgb/2, vol.a)``
    and the normal texture ``(normal, |normal|)``.

    In the reference these are Rgba16Float storage textures; we keep f32 for
    accumulation parity and let callers downcast.
    """
    g = jnp.arange(dims, dtype=jnp.float32)
    zz, yy, xx = jnp.meshgrid(g, g, g, indexing="ij")
    gid = jnp.stack([xx, yy, zz], axis=-1)  # texel coord (x, y, z)
    coord = (gid - dims / 2.0) / dims
    vol = noise_volume(coord, time)
    nrm = gradient(coord, time, 1e-4)
    density_tex = jnp.concatenate([vol[..., :3] / 2.0, vol[..., 3:4]], axis=-1)
    normal_tex = jnp.concatenate(
        [nrm, jnp.linalg.norm(nrm, axis=-1, keepdims=True)], axis=-1
    )
    return density_tex, normal_tex


@partial(jax.jit, static_argnames=("dims",))
def generate_density_u8(time=0.0, dims: int = 512):
    """Time-varying (dims, dims, dims) uint8 density: the radially masked
    fbm alpha of :func:`noise_volume` at every voxel, quantized to the
    bonsai march's R8Unorm voxel format -- BASELINE.json config 5's
    per-batch volume update (the reference's analog is the xor compute fill
    re-dispatched per update, shaders/xor.wgsl:69-77). XLA fuses the whole
    fill into one elementwise pass on the device."""
    g = jnp.arange(dims, dtype=jnp.float32)
    zz, yy, xx = jnp.meshgrid(g, g, g, indexing="ij")
    coord = (jnp.stack([xx, yy, zz], axis=-1) - dims / 2.0) / dims
    alpha = noise_volume(coord, time)[..., 3]
    return jnp.clip(alpha * 255.0 + 0.5, 0.0, 255.0).astype(jnp.uint8)


def trig_field(coord, time=0.0):
    """Framework-defined trigonometric density field (BASELINE.json config 1).

    A smooth product-of-sines density windowed to the [-1,1] box — designed to
    exercise the same march/composite path as ``noise_volume`` with a cheaper,
    fully analytic integrand. Returns (..., 4).
    """
    time = jnp.asarray(time, jnp.float32)
    x, y, z = coord[..., 0], coord[..., 1], coord[..., 2]
    val = 0.5 + 0.5 * jnp.sin(8.0 * x + time) * jnp.sin(8.0 * y + 0.5 * time) * jnp.sin(
        8.0 * z
    )
    alpha = val * smoothstep(0.9, 0.2, jnp.linalg.norm(coord, axis=-1))
    return jnp.stack([val, val, val, alpha], axis=-1)
