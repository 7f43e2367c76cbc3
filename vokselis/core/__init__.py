"""Core math: camera, global uniforms, ray geometry, color transforms, config."""

from vokselis.core.camera import Camera, CameraUniform
from vokselis.core.uniforms import GlobalUniform
from vokselis.core.config import RenderConfig

__all__ = ["Camera", "CameraUniform", "GlobalUniform", "RenderConfig"]
