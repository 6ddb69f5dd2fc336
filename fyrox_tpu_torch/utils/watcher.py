"""Filesystem watcher for resource hot reload (the port's copy of
``fyrox_tpu.utils.watcher``).

Equivalent of fyrox-core/src/watcher.rs (`FileSystemWatcher`, a wrapper
over the `notify` crate) + the resource-manager reload hookup
(fyrox-resource/src/manager.rs `update` → `try_reload_resource_from_path`).
With no OS event API guaranteed here, this polls modification times on a
fixed interval — same externally visible behavior: edit a file on disk,
the resource it backs reloads and listeners fire.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional

from fyrox_tpu_torch.core.log import Log

__all__ = ["FileSystemWatcher"]


class FileSystemWatcher:
    """Polls watched paths (files, or directories scanned recursively) and
    reports changed files. Optionally bound to a ResourceManager so changed
    cached resources reload automatically (`update`)."""

    def __init__(self, paths=(), interval: float = 0.5, manager=None):
        self.interval = float(interval)
        self.manager = manager
        self._paths: List[str] = []
        self._mtimes: Dict[str, float] = {}
        self._last_poll = 0.0
        self._listeners: List[Callable[[str], None]] = []
        for p in paths:
            self.watch(p)

    def watch(self, path: str):
        path = os.path.abspath(path)
        self._paths.append(path)
        for f in self._scan(path):
            self._mtimes[f] = self._mtime(f)

    def add_listener(self, fn: Callable[[str], None]):
        self._listeners.append(fn)

    @staticmethod
    def _mtime(path: str) -> float:
        try:
            return os.stat(path).st_mtime
        except OSError:
            return -1.0

    @staticmethod
    def _scan(path: str):
        if os.path.isdir(path):
            for root, _, files in os.walk(path):
                for f in files:
                    yield os.path.join(root, f)
        else:
            yield path

    def poll(self, now: Optional[float] = None) -> List[str]:
        """Check watched paths; returns files changed/created since the last
        poll. Rate-limited to `interval` (pass `now` to override the clock
        in tests)."""
        t = time.monotonic() if now is None else now
        if t - self._last_poll < self.interval:
            return []
        self._last_poll = t
        changed = []
        seen = set()
        for p in self._paths:
            for f in self._scan(p):
                seen.add(f)
                m = self._mtime(f)
                if f not in self._mtimes:
                    self._mtimes[f] = m
                    changed.append(f)
                elif m != self._mtimes[f]:
                    self._mtimes[f] = m
                    changed.append(f)
        # deleted files drop out of the table (reported once as changed)
        for f in [k for k in self._mtimes if k not in seen]:
            del self._mtimes[f]
            changed.append(f)
        return changed

    def update(self, now: Optional[float] = None) -> List[str]:
        """poll() + hot reload: changed files that back a cached resource in
        the bound manager are re-requested (manager.rs update loop)."""
        changed = self.poll(now)
        if self.manager is not None:
            for f in changed:
                if self.manager.try_get(f) is not None:
                    Log.info(f"hot reload: {f}")
                    self.manager.unload(f)
                    self.manager.request(f)
                    for fn in self._listeners:
                        fn(f)
        return changed
