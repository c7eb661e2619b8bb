"""Named aggregating phase timers, printed as the reference prints them.

The counterpart of ``gpusolve_tpu/utils/timer.py``: each ``Took Xms``
progress line carries the named counters, e.g. ``sumBuffer: Yms (Nx)``.
CUDA work is asynchronous, so a section that must include the device's
time passes ``block_on=<tensor>``: for a CUDA tensor the clock stops after
``torch.cuda.synchronize``.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict

import torch


class Timer:
    """Aggregating named counters, printed as ``name: Xms (Nx)``."""

    def __init__(self) -> None:
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    @contextmanager
    def section(self, name: str, block_on=None):
        """Time a section; with ``block_on`` a CUDA tensor, wait for its
        device before stopping the clock."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None and block_on.is_cuda:
                torch.cuda.synchronize(block_on.device)
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self._totals[name] = self._totals.get(name, 0.0) + seconds
        self._counts[name] = self._counts.get(name, 0) + 1

    def suffix(self) -> str:
        """The counter suffix of a ``Took Xms`` line; counters reset after
        printing."""
        parts = [
            f", {name}: {int(total * 1000)}ms ({self._counts[name]}x)"
            for name, total in self._totals.items()
        ]
        self._totals.clear()
        self._counts.clear()
        return "".join(parts)
