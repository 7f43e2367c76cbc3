"""vokselis — a JAX volume-rendering framework.

A ground-up rebuild of the capabilities of pudnax/vokselis (Rust + wgpu/WGSL)
as an idiomatic JAX engine:

- the reference's WGSL raymarch kernels (shaders/raycast_naive.wgsl,
  shaders/raycast_compute.wgsl, shaders/xor.wgsl, shaders/present.wgsl) become
  jitted JAX ops and, for the bonsai march, a Pallas GPU kernel
  (:mod:`vokselis.ops`; :mod:`vokselis.ops.backend` picks the path);
- its orbit camera (src/camera.rs) becomes a pure-JAX camera module
  (:mod:`vokselis.core.camera`);
- its wgpu device context / HDR backbuffer / present pass (src/context.rs and
  submodules) become :mod:`vokselis.engine`;
- its shader hot-reload watcher (src/watcher.rs) becomes re-jit-on-edit
  reloading (:mod:`vokselis.engine.reload`);
- its screenshot/ffmpeg recorder (src/utils/recorder.rs) becomes a host-side
  capture pipeline with a native C++ fast path (:mod:`vokselis.media`);
- scale-out over device meshes (absent in the single-GPU reference) lives in
  :mod:`vokselis.parallel`.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Persistent compilation cache: JAX_COMPILATION_CACHE_DIR when it is set
# (JAX reads it itself), otherwise a fixed directory inside the checkout --
# the path is part of the cache key, so it must not move between runs.
CACHE_DIR = _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)

from vokselis.core.camera import Camera, CameraUniform
from vokselis.core.uniforms import GlobalUniform
from vokselis.core.config import RenderConfig
from vokselis.utils.grid import dispatch_optimal

__all__ = [
    "Camera",
    "CameraUniform",
    "GlobalUniform",
    "RenderConfig",
    "dispatch_optimal",
    "__version__",
]
