"""Engine tests: context update cycle, frame loop with scripted events,
compiler diagnostics, reload registry, input state, demos."""

import numpy as np
import jax.numpy as jnp

from vokselis.core.camera import Camera
from vokselis.engine.compiler import KernelCompiler
from vokselis.engine.context import Context, HdrBackBuffer
from vokselis.engine.input import Input
from vokselis.engine.loop import run
from vokselis.engine.profiler import FrameCounter, PassTimer
from vokselis.models.trig import TrigDemo


class TestContext:
    def test_update_cycle(self):
        ctx = Context(width=64, height=64)
        ctx.update(time=1.5, time_delta=1 / 30)
        assert float(ctx.global_uniform.time) == 1.5
        assert int(ctx.global_uniform.frame) == 0
        ctx.update(time=2.0)
        assert int(ctx.global_uniform.frame) == 1
        # resolution reflects the backbuffer (context.rs:228), not the window
        assert tuple(np.asarray(ctx.global_uniform.resolution)) == (1280.0, 720.0)

    def test_camera_dirty_flag(self):
        ctx = Context(width=64, height=64)
        before = np.asarray(ctx.camera_uniform.proj_view)
        ctx.camera.add_yaw(0.5)
        assert ctx.camera.updated
        ctx.update(time=0.0)
        assert not ctx.camera.updated
        after = np.asarray(ctx.camera_uniform.proj_view)
        assert not np.allclose(before, after)

    def test_resize_keeps_backbuffer(self):
        # hdr_backbuffer.rs:10-11 — backbuffer fixed, window resizes
        ctx = Context(width=640, height=360, backbuffer_resolution=(64, 36))
        ctx.resize(320, 180)
        assert ctx.render_backbuffer.resolution == (64, 36)
        assert ctx.width == 320
        assert ctx.camera.aspect == 320 / 180

    def test_present_and_capture(self):
        ctx = Context(width=32, height=32, backbuffer_resolution=(16, 16))
        ctx.render_backbuffer.store(jnp.full((16, 16, 4), 0.5, jnp.float32))
        img = ctx.render()
        assert img.shape == (32, 32, 4)
        frame = ctx.capture_frame()
        assert frame.dtype == np.uint8
        assert frame.shape == (32, 32, 4)


class TestLoop:
    def test_scripted_trig_run(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        events = [
            {"type": "mouse_button", "pressed": True},
            {"type": "mouse_move", "x": 10, "y": 10, "dragging": False},
            None,
            {"type": "mouse_move", "x": 30, "y": 12, "dragging": True},
            None,
            {"type": "key", "key": "f11", "pressed": True},
            None,
        ]
        ctx = run(
            TrigDemo, width=64, height=36, frames=4,
            events=iter(events), quiet=True,
            context=Context(width=64, height=36, backbuffer_resolution=(64, 36)),
        )
        assert ctx.display_image is not None
        img = np.asarray(ctx.display_image)
        assert img.shape == (36, 64, 4)
        # the triangle must be visible: blue channel = 1 inside
        assert img[..., 2].max() > 0.9
        import os, time
        for _ in range(50):  # screenshot lands asynchronously
            if os.path.isdir("screenshots") and os.listdir("screenshots"):
                break
            time.sleep(0.1)
        assert os.listdir("screenshots")

    def test_esc_exits(self):
        events = [{"type": "key", "key": "esc", "pressed": True}]
        ctx = run(
            TrigDemo, width=32, height=32, frames=100,
            events=iter(events), quiet=True,
            context=Context(width=32, height=32, backbuffer_resolution=(32, 32)),
        )
        assert ctx.frame <= 2


class TestCompiler:
    def test_success(self):
        c = KernelCompiler()
        res = c.create_kernel(lambda x: x * 2, (jnp.ones(4),))
        assert res.ok
        out = res.compiled(jnp.arange(4.0))
        np.testing.assert_allclose(np.asarray(out), [0, 2, 4, 6])

    def test_failure_returns_diagnostics(self):
        c = KernelCompiler()

        def bad(x):
            return x @ jnp.ones((5, 5))  # shape mismatch

        res = c.create_kernel(bad, (jnp.ones((3, 4)),))
        assert not res.ok
        assert "Error" in res.error or "error" in res.error.lower()

    def test_cache(self):
        c = KernelCompiler()
        r1 = c.create_kernel_cached("k", lambda x: x + 1, (jnp.ones(2),))
        r2 = c.create_kernel_cached("k", lambda x: x + 1, (jnp.ones(2),))
        assert r1 is r2


class TestInput:
    def test_position_nudging(self):
        from vokselis.core.uniforms import GlobalUniform

        inp = Input()
        assert inp.update_key("up", True)
        assert inp.update_key("right", True)
        assert not inp.update_key("f1", True)  # unhandled -> demo
        u = inp.process_position(GlobalUniform.default())
        np.testing.assert_allclose(np.asarray(u.pos), [0.01, 0.01, 0.0], atol=1e-7)

    def test_mouse_ndc_flip(self):
        inp = Input()
        inp.update_mouse_pos(0, 0, 100, 100)
        assert inp.mouse == (-1.0, 1.0)
        inp.update_mouse_pos(100, 100, 100, 100)
        assert inp.mouse == (1.0, -1.0)


class TestProfiler:
    def test_frame_counter_reports(self, capsys):
        fc = FrameCounter(report_every=3)
        for _ in range(3):
            fc.record()
        out = capsys.readouterr().out
        assert "Avg frame time" in out

    def test_pass_timer(self, capsys):
        pt = PassTimer("test pass", report_every=2)
        for _ in range(2):
            with pt.measure(n_rays=100):
                pass
        out = capsys.readouterr().out
        assert "Time on test pass" in out


class TestReload:
    def test_reload_swaps_and_survives_failure(self, tmp_path, monkeypatch):
        import importlib.util
        import sys
        import time

        from vokselis.engine.reload import FnPipeline, Watcher

        mod_path = tmp_path / "hotmod.py"
        mod_path.write_text("def kernel():\n    return 1\n")
        spec = importlib.util.spec_from_file_location("hotmod", mod_path)
        module = importlib.util.module_from_spec(spec)
        sys.modules["hotmod"] = module
        spec.loader.exec_module(module)

        w = Watcher(autostart=False)
        pipe = w.register(module, FnPipeline(module, "kernel"))
        assert pipe() == 1

        time.sleep(0.01)
        mod_path.write_text("def kernel():\n    return 2\n")
        import os
        os.utime(mod_path, (time.time() + 1, time.time() + 1))
        w.poll_once()
        assert pipe() == 2

        # a broken edit keeps the old kernel (watcher.rs:92-101)
        mod_path.write_text("def kernel(:\n")
        os.utime(mod_path, (time.time() + 2, time.time() + 2))
        w.poll_once()
        assert pipe() == 2
        del sys.modules["hotmod"]
