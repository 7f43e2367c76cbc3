"""Pallas GPU kernels (Triton route) -- the performance path.

- K1 raycast_naive.wgsl -> :mod:`march_bonsai`: one ray per lane, the carry
  in registers, trilinear taps gathered from the flat uint8 volume, and an
  exit per block once every ray in it is done. Parity-tested against
  :func:`vokselis.ops.reference.render_bonsai_rays`.

The procedural trig/xor marches have no kernel: their per-step work is
arithmetic that XLA fuses into the oracle's loop body.
"""

from vokselis.ops.pallas.march_bonsai import (
    march_rays,
    render_bonsai_kernel,
    render_bonsai_rays_kernel,
)

__all__ = [
    "march_rays",
    "render_bonsai_kernel",
    "render_bonsai_rays_kernel",
]
