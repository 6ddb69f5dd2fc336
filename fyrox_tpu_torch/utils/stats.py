"""Performance statistics and tracing helpers (the port's
``fyrox_tpu.utils.stats``).

The reference's wall-clock counters (``PerformanceStatistics``,
engine/mod.rs:192, scene/mod.rs:300; ``PhysicsPerformanceStatistics``,
physics/mod.rs:199) and its GPU debug scopes (server.begin_scope). Device
work is profiled with ``torch.profiler``: ``scope`` names a range that the
trace shows around the kernels it launched, and ``trace_to`` writes a
Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch

__all__ = ["PerformanceStatistics", "scope", "trace_to"]


def _sync(block_on):
    """Wait for the devices of the tensors in `block_on` (a tensor or a
    nest of tuples / lists of them) to finish their queued work."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, (tuple, list)):
            for y in x:
                visit(y)

    visit(block_on)
    for d in devices:
        torch.cuda.synchronize(d)


class PerformanceStatistics:
    """Accumulates wall-clock timings per phase across frames."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def measure(self, name: str, block_on=None):
        """Time the block; where `block_on` is given (tensors, or a state
        of them), first wait for their devices to finish the work the
        block queued."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _sync(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def mean_ms(self, name: str) -> float:
        c = self.counts.get(name, 0)
        return (self.totals[name] / c * 1e3) if c else 0.0

    def report(self) -> str:
        lines = [f"{k}: {self.mean_ms(k):.2f} ms avg over {self.counts[k]}"
                 for k in sorted(self.totals)]
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


def scope(name: str):
    """A named range for device work: ``torch.profiler.record_function``,
    which a profiler trace shows around the kernels launched inside it
    (the reference's server.begin_scope GPU debug groups)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Profile the block with torch.profiler (the CPU, and CUDA where a
    card is present) and write a Chrome trace (``trace.json``, for
    chrome://tracing or Perfetto) into `log_dir`. Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
