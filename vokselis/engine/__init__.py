"""Engine: device context, demo protocol, frame loop, hot reload, profiling.

Rebuilds the reference's host layers L2/L4/L5 (SURVEY.md §1) the JAX way:
the wgpu device/queue/surface becomes the JAX device + framebuffer arrays,
the shader compiler becomes jit-with-diagnostics, the swapchain present
becomes a fused tonemap + host readback, and WGSL hot-reload becomes
re-jit-on-edit.
"""

from vokselis.engine.context import Context, HdrBackBuffer, renderer_info
from vokselis.engine.demo import Demo
from vokselis.engine.loop import run, print_help
from vokselis.engine.reload import Watcher, ReloadablePipeline
from vokselis.engine.compiler import KernelCompiler, CompileResult
from vokselis.engine.profiler import FrameCounter, PassTimer
from vokselis.engine.input import Input

__all__ = [
    "Context",
    "HdrBackBuffer",
    "renderer_info",
    "Demo",
    "run",
    "print_help",
    "Watcher",
    "ReloadablePipeline",
    "KernelCompiler",
    "CompileResult",
    "FrameCounter",
    "PassTimer",
    "Input",
]
