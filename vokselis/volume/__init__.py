"""Voxel volumes: .raw IO, wgpu-exact samplers, procedural density fields."""

from vokselis.volume.io import load_raw, synthetic_bonsai, get_bonsai
from vokselis.volume.sample import (
    sample_trilinear_r8,
    sample_nearest,
    trilinear_weights,
)
from vokselis.volume import fields

__all__ = [
    "load_raw",
    "synthetic_bonsai",
    "get_bonsai",
    "sample_trilinear_r8",
    "sample_nearest",
    "trilinear_weights",
    "fields",
]
