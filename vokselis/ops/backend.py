"""The one place that chooses how the bonsai march runs.

- platform ``gpu``: the Pallas march kernel
  (:mod:`vokselis.ops.pallas.march_bonsai`);
- platform ``cpu``: the jnp oracle (:mod:`vokselis.ops.reference`) -- the
  explicit CPU mode of the tests and of ``--cpu``, not a fallback;
- any other platform: :class:`UnsupportedPlatform`.

The procedural trig and xor marches have no kernel: XLA compiles their
oracles on both platforms, so they only need :func:`platform` to refuse an
unsupported device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vokselis.ops import reference
from vokselis.ops.pallas import march_bonsai

MAX_STEPS_BONSAI = reference.MAX_STEPS_BONSAI
PLATFORMS = ("gpu", "cpu")


class UnsupportedPlatform(RuntimeError):
    pass


def platform(name: str | None = None) -> str:
    """``name`` or the platform of JAX's first device, checked."""
    name = jax.devices()[0].platform if name is None else name
    if name not in PLATFORMS:
        raise UnsupportedPlatform(
            f"no bonsai march for platform {name!r}; supported: {PLATFORMS}")
    return name


def require_gpu() -> jax.Device:
    """The first device, which must be a GPU (benchmarks and the chip
    smoke test measure nothing else)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise UnsupportedPlatform(
            f"needs a GPU; JAX's first device is {dev.platform!r} ({dev})")
    return dev


def _oracle_rays(vol, eye, dxyz, max_steps=MAX_STEPS_BONSAI, srgb=True):
    return reference.render_bonsai_rays(vol, eye, jnp.stack(dxyz, axis=-1),
                                        max_steps=max_steps, srgb=srgb)


def bonsai_rays_fn(name: str | None = None):
    """The ray-set march for the platform:
    ``fn(vol_u8, eye, (dx, dy, dz), max_steps, srgb) -> (H, W, 4)``."""
    return {"gpu": march_bonsai.render_bonsai_rays_kernel,
            "cpu": _oracle_rays}[platform(name)]


def bonsai_frame_fn(name: str | None = None):
    """The whole-frame render for the platform:
    ``fn(vol_u8, camera_uniform, width=, height=, max_steps=, srgb=)``."""
    return {"gpu": march_bonsai.render_bonsai_kernel,
            "cpu": reference.render_bonsai}[platform(name)]


def render_bonsai(vol_u8, camera_uniform, width: int = 1280, height: int = 720,
                  max_steps: int = MAX_STEPS_BONSAI, srgb: bool = True):
    """Render one bonsai frame on the current platform."""
    return bonsai_frame_fn()(vol_u8, camera_uniform, width=width,
                             height=height, max_steps=max_steps, srgb=srgb)


def build_renderer(vol_u8):
    """Functional pair ``(render, pack)`` for jit pipelines:
    ``render(pack, camera_uniform, width, height, max_steps=, srgb=)``.
    The pack is the uint8 volume on the device; it travels as an argument
    so it is never baked into the program as a constant."""
    frame = bonsai_frame_fn()
    pack = jnp.asarray(vol_u8, jnp.uint8)

    def render(pk, camera_uniform, width, height,
               max_steps=MAX_STEPS_BONSAI, srgb=True):
        return frame(pk, camera_uniform, width=width, height=height,
                     max_steps=max_steps, srgb=srgb)

    return render, pack


class BonsaiRenderer:
    """Holds the volume on the device; call to render a frame (the analog of
    the reference's VolumeTexture + RaycastPipeline pair,
    examples/bonsai/raycast.rs:12-141)."""

    def __init__(self, vol_u8):
        self.render_fn, self.vol = build_renderer(vol_u8)

    def __call__(self, camera_uniform, width: int = 1280, height: int = 720,
                 max_steps: int = MAX_STEPS_BONSAI, srgb: bool = True):
        return self.render_fn(self.vol, camera_uniform, width, height,
                              max_steps=max_steps, srgb=srgb)
