"""Generational-index pools (host-side; the port's copy of
``fyrox_tpu.core.pool``).

Equivalent of the reference's universal storage `Pool<T>` / `Handle<T>`
(fyrox-core/src/pool/mod.rs:69: handle = (index: u32, generation: u32),
INVALID_GENERATION = 0 :63, spawn :534, try_borrow :828, free :1003, ticket
take/put-back). The batched runtime stores everything as dense arrays, but
the host-side tooling (builders, asset registry, editor-style workflows)
keeps the same arena semantics: stale handles are detected by generation
mismatch rather than causing aliasing bugs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Generic, List, Optional, TypeVar

T = TypeVar("T")

__all__ = ["Handle", "Pool", "INVALID_GENERATION"]

INVALID_GENERATION = 0  # pool/mod.rs:63


@dataclass(frozen=True)
class Handle(Generic[T]):
    index: int = 0
    generation: int = INVALID_GENERATION

    @staticmethod
    def none() -> "Handle":
        return Handle(0, INVALID_GENERATION)

    def is_none(self) -> bool:
        return self.generation == INVALID_GENERATION

    def is_some(self) -> bool:
        return not self.is_none()


class Pool(Generic[T]):
    """Generational arena. Freed slots are recycled with a bumped
    generation, so handles into freed slots read as dead."""

    def __init__(self):
        self._payload: List[Optional[T]] = []
        self._generation: List[int] = []
        self._free: List[int] = []

    def __len__(self):
        return sum(1 for p in self._payload if p is not None)

    @property
    def capacity(self):
        return len(self._payload)

    def spawn(self, value: T) -> Handle[T]:
        """pool/mod.rs:534"""
        if self._free:
            idx = self._free.pop()
            self._generation[idx] += 1
            self._payload[idx] = value
        else:
            idx = len(self._payload)
            self._payload.append(value)
            self._generation.append(1)
        return Handle(idx, self._generation[idx])

    def spawn_at(self, index: int, value: T) -> Handle[T]:
        """pool/mod.rs:553 — place at a specific slot (grows the pool)."""
        while len(self._payload) <= index:
            self._free.append(len(self._payload))
            self._payload.append(None)
            self._generation.append(INVALID_GENERATION)
        if self._payload[index] is not None:
            raise ValueError(f"slot {index} is occupied")
        if index in self._free:
            self._free.remove(index)
        self._generation[index] += 1
        self._payload[index] = value
        return Handle(index, self._generation[index])

    def is_valid(self, handle: Handle[T]) -> bool:
        return (handle.is_some()
                and handle.index < len(self._payload)
                and self._generation[handle.index] == handle.generation
                and self._payload[handle.index] is not None)

    def try_borrow(self, handle: Handle[T]) -> Optional[T]:
        """pool/mod.rs:828 — None for stale/invalid handles."""
        return self._payload[handle.index] if self.is_valid(handle) else None

    def borrow(self, handle: Handle[T]) -> T:
        v = self.try_borrow(handle)
        if v is None:
            raise KeyError(f"invalid handle {handle}")
        return v

    def replace(self, handle: Handle[T], value: T) -> T:
        old = self.borrow(handle)
        self._payload[handle.index] = value
        return old

    def free(self, handle: Handle[T]) -> T:
        """pool/mod.rs:1003"""
        v = self.borrow(handle)
        self._payload[handle.index] = None
        self._free.append(handle.index)
        return v

    def take_reserve(self, handle: Handle[T]):
        """Ticket take: temporary exclusive ownership (used by the
        reference's graph update to move nodes out of the pool)."""
        v = self.borrow(handle)
        self._payload[handle.index] = None
        return (handle, v)

    def put_back(self, ticket, value: T) -> Handle[T]:
        handle, _ = ticket
        self._payload[handle.index] = value
        return handle

    def iter(self):
        for idx, (p, g) in enumerate(zip(self._payload, self._generation)):
            if p is not None:
                yield Handle(idx, g), p

    def handles(self):
        return [h for h, _ in self.iter()]
