"""Hot reload: watch Python kernel/scene sources, re-jit, swap in place.

Rebuilds the reference's shader watcher (src/watcher.rs): a background thread
watches registered source files (stat-polling — no inotify dependency) and on
change recompiles on the watcher thread; on success the new callable is
swapped into every registered pipeline and the terminal blinks green
(src/watcher.rs:78-90); on failure diagnostics go to stderr and the old
kernel keeps rendering (src/watcher.rs:92-101) — a bad edit never kills the
app. The registry is a path -> [pipelines] multimap exactly like
ContiniousHashMap (src/watcher.rs:27, src/utils/mod.rs:48-89).

Unlike the reference there is no cross-thread pipeline mutation hazard
(Rc::get_mut_unchecked, src/context.rs:308-316): reloads mutate a
ReloadablePipeline's ``fn`` attribute under a lock, and jitted callables are
immutable values.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import sys
import threading
import time
import traceback
from typing import Callable, Protocol, runtime_checkable

from vokselis.utils.misc import ContinuousDict, green_blink


@runtime_checkable
class ReloadablePipeline(Protocol):
    """Anything with a ``reload(module)`` method (src/watcher.rs:21-23)."""

    def reload(self, module) -> None: ...


class FnPipeline:
    """Simplest reloadable: holds a callable rebuilt from a module attr."""

    def __init__(self, module, attr: str):
        self.attr = attr
        self.fn = getattr(module, attr)

    def reload(self, module):
        self.fn = getattr(module, self.attr)

    def __call__(self, *a, **kw):
        return self.fn(*a, **kw)


class Watcher:
    """Stat-polling source watcher with a reload registry."""

    def __init__(self, poll_interval: float = 0.5, autostart: bool = True):
        self.registry = ContinuousDict()  # path -> [(module_name, pipeline)]
        self._mtimes: dict = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.poll_interval = poll_interval
        self._thread = None
        if autostart:
            self.start()

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="source-watcher", daemon=True
            )
            self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def register(self, module, pipeline):
        """Watch ``module``'s source file; on change, reload ``pipeline``.

        Returns the pipeline (mirrors Watcher::register, src/watcher.rs:45-54).
        """
        path = os.path.abspath(module.__file__)
        with self._lock:
            self.registry.push_value(path, (module.__name__, pipeline))
            self._mtimes.setdefault(path, os.path.getmtime(path))
        return pipeline

    # --- watcher thread (src/watcher.rs:57-110) --------------------------
    def _loop(self):
        while not self._stop.wait(self.poll_interval):
            self.poll_once()

    def poll_once(self):
        """One poll cycle (also callable synchronously from tests)."""
        with self._lock:
            items = [(p, list(v)) for p, v in self.registry.items()]
        for path, entries in items:
            try:
                mtime = os.path.getmtime(path)
            except OSError:
                continue
            if mtime == self._mtimes.get(path):
                continue
            self._mtimes[path] = mtime
            self._reload_path(path, entries)

    @staticmethod
    def _reload_module(module_name, path):
        try:
            return importlib.reload(sys.modules[module_name])
        except (ModuleNotFoundError, ImportError):
            # modules loaded from an explicit path (outside sys.path)
            spec = importlib.util.spec_from_file_location(module_name, path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            sys.modules[module_name] = module
            return module

    def _reload_path(self, path, entries):
        for module_name, pipeline in entries:
            try:
                module = self._reload_module(module_name, path)
                pipeline.reload(module)
                green_blink()
                print(f"reloaded {os.path.basename(path)}")
            except Exception:
                # keep the old pipeline live (src/watcher.rs:92-101)
                print(
                    f"reload of {path} failed; keeping previous kernel:\n"
                    + traceback.format_exc(),
                    file=sys.stderr,
                )
