"""Step timing (counterpart of ``papc_tpu/utils/profiling.py``).

:class:`StepTimer` times steps with CUDA events on a CUDA device: a
window opens at the first ``start`` after a sync and closes at a syncing
``stop``, which records an event, waits for it and spreads the window's
time evenly over the steps inside it. Host time between the steps of a
window (data loading) counts, so the averages are throughput times. On
the CPU it reads the host clock, which the CPU's synchronous work makes
exact.
"""

from __future__ import annotations

import time

import torch


class StepTimer:
    """Running average step time in seconds. ``stop(sync=False)`` keeps
    the window open over the next step."""

    def __init__(self, device="cuda"):
        self.cuda = torch.device(device).type == "cuda"
        self.total = 0.0
        self.count = 0
        self.last = None  # the last window's seconds a step
        self._start = None
        self._pending = 0

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def start(self) -> None:
        if self._start is None:
            self._start = self._mark()

    def stop(self, sync: bool = True, steps: int = 1) -> float | None:
        """End one step (or ``steps``). A syncing stop returns the
        window's seconds a step; any other returns None."""
        self._pending += steps
        if not sync:
            return None
        end = self._mark()
        if self.cuda:
            end.synchronize()
            dt = self._start.elapsed_time(end) / 1e3
        else:
            dt = end - self._start
        self.total += dt
        self.count += self._pending
        self.last = dt / self._pending
        self._pending = 0
        self._start = None
        return self.last

    def discard(self) -> None:
        """Drop the open window (after an eval or checkpoint pause, so its
        time is not counted as training)."""
        self._pending = 0
        self._start = None

    @property
    def avg(self) -> float:
        return self.total / max(self.count, 1)
