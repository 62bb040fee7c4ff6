"""Step timing (port of ``ocflow_tpu/utils/profiling.py`` ``StepTimer``).

The host clock at each ``tick``. On the card a step returns once its
kernels are queued, so a rate over many steps is the queuing rate, which
the device's pace bounds once the queue fills (the training loop syncs at
each metrics fetch). Time device work with CUDA events (``bench.cuda_ms``).
"""

from __future__ import annotations

import time


class StepTimer:
    """Images/s since the ``warmup``-th tick."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._count = 0
        self._start = None
        self._images = 0

    def tick(self, batch_size: int):
        self._count += 1
        if self._count == self.warmup:
            self._start = time.perf_counter()
            self._images = 0
        elif self._count > self.warmup:
            self._images += batch_size

    @property
    def images_per_sec(self) -> float:
        if self._start is None or self._images == 0:
            return 0.0
        return self._images / (time.perf_counter() - self._start)
