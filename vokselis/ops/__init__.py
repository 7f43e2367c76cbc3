"""Render ops: pure-jnp oracle renderers, the GPU march kernel, present pass.

The jnp renderers in :mod:`vokselis.ops.reference` are the correctness
oracles and the CPU mode; the Pallas kernel in :mod:`vokselis.ops.pallas` is
the GPU path for the bonsai march and is parity-tested against the oracle.
:mod:`vokselis.ops.backend` is the one place that chooses between them.
"""

from vokselis.ops.reference import (
    render_bonsai,
    render_compute_tex,
    render_compute_inline,
    render_field,
    MAX_STEPS_BONSAI,
    MAX_STEPS_COMPUTE,
)
from vokselis.ops.present import present
from vokselis.ops.backend import BonsaiRenderer, build_renderer

__all__ = [
    "BonsaiRenderer",
    "build_renderer",
    "render_bonsai",
    "render_compute_tex",
    "render_compute_inline",
    "render_field",
    "present",
    "MAX_STEPS_BONSAI",
    "MAX_STEPS_COMPUTE",
]
