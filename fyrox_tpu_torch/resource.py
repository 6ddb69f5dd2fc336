"""Resource management: request-by-path with dedup + async loading (the
port's copy of ``fyrox_tpu.resource``, on the port's loaders).

Equivalent of fyrox-resource's `ResourceManager` (manager.rs:87/595:
request<T> with per-path deduplication, async loading on the shared
TaskPool, Pending→Ok/LoadError state machine per state.rs, loaders
registry loader.rs:98, event broadcasting event.rs).

Loaders run on the host and return what the port's loaders return: a
SceneTemplate (.rgs), mono float32 samples (.wav, .ogg), a GltfScene
(.gltf, .glb) or a Texture (images).
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional

from fyrox_tpu_torch.core.log import Log
from fyrox_tpu_torch.core.task import TaskPool
from fyrox_tpu_torch.io.gltf import load_gltf
from fyrox_tpu_torch.io.rgs_scene import load_scene
from fyrox_tpu_torch.render.texture import load_texture
from fyrox_tpu_torch.sound.engine import load_wav
from fyrox_tpu_torch.sound.ogg import load_ogg

__all__ = ["ResourceState", "Resource", "ResourceManager"]


class ResourceState(Enum):
    PENDING = 0
    OK = 1
    LOAD_ERROR = 2


@dataclass
class Resource:
    path: str
    state: ResourceState = ResourceState.PENDING
    data: Any = None
    error: Optional[str] = None
    _event: threading.Event = field(default_factory=threading.Event)

    def is_ok(self):
        return self.state == ResourceState.OK

    def wait(self, timeout=None) -> "Resource":
        """Block until loaded (the sync path the reference offers through
        block_on)."""
        self._event.wait(timeout)
        return self


class ResourceManager:
    """Loaders are registered per extension; requests dedupe by absolute
    path and resolve asynchronously on the task pool."""

    def __init__(self, max_workers: int = 4):
        self._loaders: Dict[str, Callable[[str], Any]] = {}
        self._cache: Dict[str, Resource] = {}
        self._lock = threading.Lock()
        self._pool = TaskPool(max_workers)
        self._listeners: List[Callable[[Resource], None]] = []
        self._register_builtin()

    def _register_builtin(self):
        self.register_loader(".rgs", load_scene)
        self.register_loader(".wav", load_wav)
        self.register_loader(".ogg", load_ogg)
        self.register_loader(".gltf", load_gltf)
        self.register_loader(".glb", load_gltf)
        for ext in (".png", ".jpg", ".jpeg", ".bmp", ".tga", ".ppm"):
            self.register_loader(ext, load_texture)

    def register_loader(self, extension: str, fn: Callable[[str], Any]):
        """loader.rs:98 registry equivalent."""
        self._loaders[extension.lower()] = fn

    def add_listener(self, fn: Callable[[Resource], None]):
        self._listeners.append(fn)

    def request(self, path: str) -> Resource:
        """Dedup request (manager.rs:595): the same path always returns the
        same Resource object; loading happens once."""
        key = os.path.abspath(path)
        with self._lock:
            if key in self._cache:
                return self._cache[key]
            res = Resource(path=key)
            self._cache[key] = res

        ext = os.path.splitext(key)[1].lower()
        loader = self._loaders.get(ext)

        def work():
            try:
                if loader is None:
                    raise ValueError(f"no loader registered for '{ext}'")
                res.data = loader(key)
                res.state = ResourceState.OK
            except Exception as e:
                res.state = ResourceState.LOAD_ERROR
                res.error = str(e)
                Log.err(f"failed to load {key}: {e}")
            finally:
                res._event.set()
                for fn in list(self._listeners):
                    try:
                        fn(res)
                    except Exception:
                        pass

        self._pool.spawn_task(work)
        return res

    def try_get(self, path: str) -> Optional[Resource]:
        return self._cache.get(os.path.abspath(path))

    def unload(self, path: str):
        with self._lock:
            self._cache.pop(os.path.abspath(path), None)

    def shutdown(self):
        self._pool.shutdown()
