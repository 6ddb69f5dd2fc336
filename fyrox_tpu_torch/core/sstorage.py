"""Interned strings + sparse buffers.

Equivalents of fyrox-core/src/sstorage.rs (ImmutableString: globally
interned, hash-cached strings used as material/shader property keys) and
fyrox-core/src/sparse.rs (SparseBuffer + AtomicIndex: stable-index
payload storage for render caches). Host-side utilities — device data
lives in SoA pools."""
from __future__ import annotations

from typing import Dict, Generic, List, Optional, TypeVar

__all__ = ["ImmutableString", "SparseBuffer", "AtomicIndex"]

T = TypeVar("T")


class ImmutableString(str):
    """Interned string with a cached hash (sstorage.rs:58).

    `ImmutableString(x) is ImmutableString(x)` for equal contents, so
    identity compares and dict lookups skip rehashing long keys."""

    _interned: Dict[str, "ImmutableString"] = {}
    __slots__ = ("_hash",)

    def __new__(cls, s: str = ""):
        cached = cls._interned.get(s)
        if cached is not None:
            return cached
        obj = super().__new__(cls, s)
        obj._hash = str.__hash__(obj)
        cls._interned[s] = obj
        return obj

    def __hash__(self):
        return self._hash

    def cached_hash(self) -> int:
        """sstorage.rs:165."""
        return self._hash

    def to_mutable(self) -> str:
        """sstorage.rs:171."""
        return str(self)

    @classmethod
    def entry_count(cls) -> int:
        """sstorage.rs:268."""
        return len(cls._interned)


_UNASSIGNED = -1


class AtomicIndex:
    """Slot handle into a SparseBuffer (sparse.rs:27). Python's GIL makes
    plain int mutation atomic for our single-process use."""

    __slots__ = ("_index",)

    def __init__(self, index: int = _UNASSIGNED):
        self._index = index

    @classmethod
    def unassigned(cls) -> "AtomicIndex":
        return cls(_UNASSIGNED)

    def set(self, index: int):
        self._index = index

    def get(self) -> int:
        return self._index

    @property
    def assigned(self) -> bool:
        return self._index != _UNASSIGNED


class SparseBuffer(Generic[T]):
    """Vec-with-free-list payload store (sparse.rs:75): spawn returns a
    stable AtomicIndex; free recycles the slot."""

    def __init__(self, capacity: int = 0):
        self._items: List[Optional[T]] = []
        self._occupied: List[bool] = []
        self._free: List[int] = []

    def spawn(self, payload: T) -> AtomicIndex:
        if self._free:
            i = self._free.pop()
            self._items[i] = payload
            self._occupied[i] = True
        else:
            i = len(self._items)
            self._items.append(payload)
            self._occupied.append(True)
        return AtomicIndex(i)

    def free(self, index: AtomicIndex) -> Optional[T]:
        out = self.free_raw(index.get())
        index.set(_UNASSIGNED)
        return out

    def free_raw(self, i: int) -> Optional[T]:
        if 0 <= i < len(self._items) and self._occupied[i]:
            out = self._items[i]
            self._items[i] = None
            self._occupied[i] = False
            self._free.append(i)
            return out
        return None

    def get(self, index: AtomicIndex) -> Optional[T]:
        i = index.get() if isinstance(index, AtomicIndex) else index
        if 0 <= i < len(self._items) and self._occupied[i]:
            return self._items[i]
        return None

    def is_index_valid(self, index: AtomicIndex) -> bool:
        i = index.get()
        return 0 <= i < len(self._items) and self._occupied[i]

    def __len__(self):
        return len(self._items)

    @property
    def filled(self) -> int:
        return sum(self._occupied)

    def __iter__(self):
        return (x for x, o in zip(self._items, self._occupied) if o)

    def clear(self):
        self._items.clear()
        self._occupied.clear()
        self._free.clear()
