"""Plugin system + code hot reload (the port's copy of
``fyrox_tpu.plugin``).

Equivalent of the reference's `Plugin` trait + dynamic-plugin hot reload
(fyrox-impl/src/plugin/mod.rs:573: register :576, init :592, update :616;
engine/hotreload.rs serializes plugin state, swaps the dylib, and
deserializes). Python's dylib is the module: `PluginHost` loads plugin
modules from source files, drives the lifecycle, and on file change
performs the same dance — `save_state()` → module reload → fresh
instance → `restore_state()` — so live-edited game logic keeps its
state across reloads.
"""
from __future__ import annotations

import importlib.util
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from fyrox_tpu_torch.utils.watcher import FileSystemWatcher

__all__ = ["Plugin", "PluginHost"]


class Plugin:
    """Base plugin (plugin/mod.rs:573). Override what you need."""

    def register(self, context) -> None:
        """Registration pass (node constructors, script types, loaders)."""

    def init(self, context) -> None:
        """Called once after registration (Plugin::init :592)."""

    def update(self, context, dt: float) -> None:
        """Per-tick logic (Plugin::update :616)."""

    def on_os_event(self, context, event) -> None:
        """OS event hook."""

    # hot-reload state round-trip (engine/hotreload.rs semantics)
    def save_state(self) -> Dict[str, Any]:
        return {}

    def restore_state(self, state: Dict[str, Any]) -> None:
        pass


@dataclass
class _Loaded:
    path: str
    module_name: str
    plugin: Plugin


class PluginHost:
    """Owns plugins, drives lifecycle, hot-reloads source-file plugins.

    A plugin module must expose `make_plugin() -> Plugin`.
    """

    def __init__(self, context=None, watch_interval=0.25):
        self.context = context
        self.plugins: List[Plugin] = []
        self._loaded: List[_Loaded] = []
        self._watcher = FileSystemWatcher(interval=watch_interval)
        self._counter = 0

    # -- static plugins ----------------------------------------------------
    def add(self, plugin: Plugin) -> Plugin:
        plugin.register(self.context)
        plugin.init(self.context)
        self.plugins.append(plugin)
        return plugin

    # -- dynamic (source-file) plugins -------------------------------------
    def load_file(self, path: str) -> Plugin:
        """Load a plugin module from a .py file and start watching it."""
        self._counter += 1
        name = f"_fyrox_plugin_{self._counter}"
        plugin = self._instantiate(path, name)
        plugin.register(self.context)
        plugin.init(self.context)
        self.plugins.append(plugin)
        self._loaded.append(_Loaded(path=path, module_name=name,
                                    plugin=plugin))
        self._watcher.watch(path)
        # prime the mtime table so the initial sighting doesn't reload
        self._watcher._mtimes[path] = self._watcher._mtime(path)
        return plugin

    def _instantiate(self, path: str, name: str) -> Plugin:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
        return module.make_plugin()

    def _on_changed(self, path: str):
        for rec in self._loaded:
            if rec.path != path:
                continue
            # hotreload.rs: serialize state → swap code → deserialize
            state = rec.plugin.save_state()
            fresh = self._instantiate(rec.path, rec.module_name)
            fresh.register(self.context)
            fresh.restore_state(state)
            idx = self.plugins.index(rec.plugin)
            self.plugins[idx] = fresh
            rec.plugin = fresh

    # -- lifecycle ---------------------------------------------------------
    def update(self, dt: float, now: Optional[float] = None):
        """Per-tick: poll the watcher (hot reload) then update plugins."""
        for f in self._watcher.poll(now):
            self._on_changed(f)
        for p in self.plugins:
            p.update(self.context, dt)

    def on_os_event(self, event):
        for p in self.plugins:
            p.on_os_event(self.context, event)
