"""Global logger with severity filtering + listener channels (the
port's copy of ``fyrox_tpu.core.log``, host only).

Equivalent of fyrox-core/src/log.rs (`Log` :98, `MessageKind` severity :77,
listener broadcast :218).
"""
from __future__ import annotations

import sys
import threading
import time
from enum import IntEnum
from typing import Callable, List, Tuple

__all__ = ["MessageKind", "Log"]


class MessageKind(IntEnum):
    INFORMATION = 0
    WARNING = 1
    ERROR = 2


class _LogState:
    def __init__(self):
        self.verbosity = MessageKind.INFORMATION
        self.listeners: List[Callable[[MessageKind, str], None]] = []
        self.lock = threading.Lock()


_STATE = _LogState()


class Log:
    @staticmethod
    def set_verbosity(kind: MessageKind):
        _STATE.verbosity = kind

    @staticmethod
    def add_listener(fn: Callable[[MessageKind, str], None]):
        with _STATE.lock:
            _STATE.listeners.append(fn)

    @staticmethod
    def writeln(kind: MessageKind, message: str):
        if kind < _STATE.verbosity:
            return
        prefix = {MessageKind.INFORMATION: "[INFO]",
                  MessageKind.WARNING: "[WARN]",
                  MessageKind.ERROR: "[ERROR]"}[kind]
        line = f"{prefix} {time.strftime('%H:%M:%S')} {message}"
        stream = sys.stderr if kind >= MessageKind.WARNING else sys.stdout
        print(line, file=stream)
        with _STATE.lock:
            listeners = list(_STATE.listeners)
        for fn in listeners:
            try:
                fn(kind, message)
            except Exception:
                pass

    @staticmethod
    def info(message: str):
        Log.writeln(MessageKind.INFORMATION, message)

    @staticmethod
    def warn(message: str):
        Log.writeln(MessageKind.WARNING, message)

    @staticmethod
    def err(message: str):
        Log.writeln(MessageKind.ERROR, message)

    @staticmethod
    def verify(result: bool, context: str):
        """Log-and-continue on failure (the reference's error philosophy —
        SURVEY.md §5 failure-detection row)."""
        if not result:
            Log.err(f"verification failed: {context}")
        return result
