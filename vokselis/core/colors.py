"""Color transforms shared by the render kernels.

Reference sources:
- scalar ``linear_to_srgb`` branch form: shaders/raycast_naive.wgsl:63-68
- vectorized ceil-select form: shaders/present.wgsl:23-30 (note exponent
  0.41666, not 1/2.4 — replicated verbatim)
- ACES filmic tonemap: shaders/present.wgsl:32-35
- cosine palette / vertigo: shaders/raycast_naive.wgsl:70-81 (TAU = 6.28318,
  the truncated constant used by the shader)
"""

from __future__ import annotations

import jax.numpy as jnp

TAU = 6.28318  # shaders/raycast_naive.wgsl:70 — deliberately not 2*pi


def smoothstep(edge0, edge1, x):
    """WGSL smoothstep: Hermite interpolation between edge0 and edge1."""
    t = jnp.clip((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def mix(a, b, t):
    """WGSL mix(a, b, t) = a*(1-t) + b*t."""
    return a + (b - a) * t


def fract(x):
    return x - jnp.floor(x)


def linear_to_srgb(x):
    """Per-channel sRGB OETF, branch form (shaders/raycast_naive.wgsl:63-68)."""
    return jnp.where(
        x <= 0.0031308,
        12.92 * x,
        1.055 * jnp.power(jnp.maximum(x, 1e-12), 1.0 / 2.4) - 0.055,
    )


def linear_to_srgb_present(rgb):
    """Vectorized ceil-select form used by the present pass
    (shaders/present.wgsl:23-30): selector = ceil(x - 0.0031308) blended with
    mix(), exponent 0.41666."""
    selector = jnp.clip(jnp.ceil(rgb - 0.0031308), 0.0, 1.0)
    under = 12.92 * rgb
    over = 1.055 * jnp.power(jnp.maximum(rgb, 1e-12), 0.41666) - 0.055
    return mix(under, over, selector)


def aces_film(x):
    """ACES filmic tonemap (shaders/present.wgsl:32-35)."""
    return jnp.clip((x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14), 0.0, 1.0)


def palette(t, a, b, c, d):
    """IQ cosine palette (shaders/raycast_naive.wgsl:71-73)."""
    return a + b * jnp.cos(TAU * (c * t + d))


def vertigo(t):
    """The 'vertigo' palette (shaders/raycast_naive.wgsl:75-81).

    ``t`` may be any shape; returns shape ``t.shape + (3,)``.
    """
    t = jnp.asarray(t)
    a = jnp.asarray([0.5, 0.5, 0.5], jnp.float32)
    b = jnp.asarray([0.5, 0.5, 0.5], jnp.float32)
    c = jnp.asarray([1.0, 1.7, 0.4], jnp.float32)
    d = jnp.asarray([0.0, 0.15, 0.20], jnp.float32)
    return palette(t[..., None], a, b, c, d)


def vertigo_soa(t):
    """vertigo palette with SoA channel outputs (r, g, b) — the form the
    march kernel uses, one ray per lane with no trailing channel axis."""
    r = 0.5 + 0.5 * jnp.cos(TAU * (1.0 * t + 0.0))
    g = 0.5 + 0.5 * jnp.cos(TAU * (1.7 * t + 0.15))
    b = 0.5 + 0.5 * jnp.cos(TAU * (0.4 * t + 0.20))
    return r, g, b


def bonsai_transfer_soa(samp):
    """K1 transfer function (raycast_naive.wgsl:101-108) in SoA form:
    sample -> (step_alpha, r, g, b): the ``min(0.9, v)`` clamp-arg-order
    quirk + smoothstep(0.10, 1.2) + vertigo, as the march kernel uses it.
    Keep it in step with ``ops.reference._bonsai_transfer`` — never fix the
    quirk in one place only."""
    tv = smoothstep(0.10, 1.2, jnp.minimum(0.9, samp))
    r, g, b = vertigo_soa(tv)
    return tv, r, g, b
