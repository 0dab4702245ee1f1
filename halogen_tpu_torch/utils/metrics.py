"""Observability: throughput meter, render statistics, structured logging
(PyTorch port of `halogen_tpu/utils/metrics.py`).

The reference's perf HUD + Debug.Log side channel
(SURVEY.md §5.1/5.5): `HalogenDebugUI.cs:37-94` keeps a rolling 1-second
window of per-frame ray counts (rays = SPP * W * H,
`HalogenRenderFeature.cs:97`) and displays MRays/s plus the accumulated
frame counter. `RaysMeter` reproduces that contract; `RenderStats`
summarizes the integrator's intersection-work counters (the heatmap data,
`HalgoenCompute.compute:192-193`) as scalars.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass


def get_logger(name: str = "halogen_tpu_torch") -> logging.Logger:
    """Structured logger (the reference used Unity Debug.Log)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"
        ))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


class RaysMeter:
    """Rolling-window rays/s meter (HalogenDebugUI.cs:37-76).

    Call `add(rays)` once per completed frame; `mrays_per_sec` averages
    over the trailing `window_s` seconds, exactly like the HUD.
    """

    def __init__(self, window_s: float = 1.0, clock=time.perf_counter):
        self.window_s = window_s
        self._clock = clock
        self._events: deque[tuple[float, int]] = deque()

    def add(self, rays: int):
        now = self._clock()
        self._events.append((now, rays))
        self._trim(now)

    def _trim(self, now: float):
        while self._events and now - self._events[0][0] > self.window_s:
            self._events.popleft()

    @property
    def rays_per_sec(self) -> float:
        if not self._events:
            return 0.0
        now = self._clock()
        self._trim(now)
        total = sum(r for _, r in self._events)
        span = max(now - self._events[0][0], 1e-9) if self._events else 1.0
        # HUD semantics: sum over the window / window length
        return total / max(span, self.window_s * 0.5)

    @property
    def mrays_per_sec(self) -> float:
        return self.rays_per_sec / 1e6


@dataclass
class RenderStats:
    """Scalar summary of one frame's intersection work + sampling state."""

    frame: int
    width: int
    height: int
    spp: int
    wall_s: float
    tri_tests_mean: float = 0.0
    box_tests_mean: float = 0.0

    @property
    def rays(self) -> int:
        # The HUD ray count (HalogenRenderFeature.cs:97)
        return self.spp * self.width * self.height

    @property
    def mrays_per_sec(self) -> float:
        return self.rays / max(self.wall_s, 1e-9) / 1e6

    def log(self, logger: logging.Logger | None = None):
        (logger or get_logger()).info(
            "frame=%d %dx%d spp=%d %.3fs %.1f Mrays/s tri_tests=%.1f "
            "box_tests=%.1f",
            self.frame, self.width, self.height, self.spp, self.wall_s,
            self.mrays_per_sec, self.tri_tests_mean, self.box_tests_mean,
        )
