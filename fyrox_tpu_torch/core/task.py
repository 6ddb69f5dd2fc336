"""Async task pool for background work (asset loading, host-side jobs;
the port's copy of ``fyrox_tpu.core.task``).

Equivalent of fyrox-core/src/task.rs (`TaskPool` :91, spawn_task :118,
spawn_with_result :135). Device compute stays in jit; this pool covers the
host-side async surface (file IO, decode, prefetch) exactly where the
reference uses its TaskPool for resource loading.
"""
from __future__ import annotations

import concurrent.futures as cf
import threading
from typing import Any, Callable, Dict, Optional

__all__ = ["TaskPool"]


class TaskPool:
    def __init__(self, max_workers: int = 4):
        self._pool = cf.ThreadPoolExecutor(max_workers=max_workers)
        self._results: Dict[int, cf.Future] = {}
        self._next_id = 0
        self._lock = threading.Lock()

    def spawn_task(self, fn: Callable[[], Any]) -> None:
        """Fire-and-forget (task.rs:118)."""
        self._pool.submit(fn)

    def spawn_with_result(self, fn: Callable[[], Any]) -> int:
        """Returns a task id whose result can be polled (task.rs:135)."""
        with self._lock:
            tid = self._next_id
            self._next_id += 1
            self._results[tid] = self._pool.submit(fn)
        return tid

    def try_take_result(self, tid: int) -> Optional[Any]:
        """Non-blocking poll; returns None while pending."""
        with self._lock:
            fut = self._results.get(tid)
        if fut is None:
            raise KeyError(f"unknown task {tid}")
        if not fut.done():
            return None
        with self._lock:
            self._results.pop(tid, None)
        return fut.result()

    def wait_result(self, tid: int, timeout=None) -> Any:
        with self._lock:
            fut = self._results.pop(tid)
        return fut.result(timeout=timeout)

    def shutdown(self):
        self._pool.shutdown(wait=True)
