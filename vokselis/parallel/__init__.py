"""Multi-device scale-out (absent in the single-GPU reference; SURVEY.md §2d):
views sharded over a device mesh, and one frame's rows sharded over it."""

from vokselis.parallel.sharding import (
    make_mesh,
    orbit_camera_batch,
    render_views_sharded,
    render_frame_tiled,
    multi_view_step,
)

__all__ = [
    "make_mesh",
    "orbit_camera_batch",
    "render_views_sharded",
    "render_frame_tiled",
    "multi_view_step",
]
