"""Device-side timing of the port's host-driven loops: the trainer's
stages (``models/edmd.py:StageClock``) and each FISTA fit's time to its
stop (``ops/lasso.py``)."""

from __future__ import annotations

import time

import torch


class DeviceClock:
    """Points in time on a device: recorded CUDA events on a CUDA device
    (read after a synchronize), the host clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, start, end) -> float:
        """Milliseconds from mark ``start`` to mark ``end``."""
        if self.cuda:
            torch.cuda.synchronize()
            return start.elapsed_time(end)
        return (end - start) * 1e3
