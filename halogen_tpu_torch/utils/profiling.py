"""Profiling hooks (PyTorch port of `halogen_tpu/utils/profiling.py`; the
reference's ProfilingScope + RenderDoc workflow): a `torch.profiler` trace
around render calls, a timed section that feeds the metrics logger (with
the card's own time by CUDA events where there is a card), and named
regions for the profiler's timeline."""

from __future__ import annotations

import contextlib
import os
import time

import torch

from halogen_tpu_torch.utils.metrics import get_logger


@contextlib.contextmanager
def trace(log_dir: str = "halogen_trace"):
    """Capture a `torch.profiler` trace of the block (the CPU, and the
    card where there is one) and write it as a Chrome trace,
    `log_dir/trace.json` (open in chrome://tracing or Perfetto). Yields
    the profiler, whose `key_averages()` sums the time by operation.

    Usage:
        with profiling.trace("chiprun_out/trace"):
            render_frame(...)
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    get_logger().info("profiler trace written to %s", path)


@contextlib.contextmanager
def timed(label: str, rays: int | None = None):
    """Wall-time a block and log it, with Mrays/s when `rays` is given
    (the HUD metric, HalogenRenderFeature.cs:97). Where there is a card the
    block is bracketed by CUDA events on the current stream and the log
    also gives the card's time; the exit waits for the card."""
    cuda = torch.cuda.is_available()
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if cuda:
            end.record()
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        msg = f"{label}: {dt:.3f}s"
        if cuda:
            msg += f" (device {start.elapsed_time(end) / 1e3:.3f}s)"
        if rays is not None:
            msg += f" ({rays / dt / 1e6:.1f} Mrays/s)"
        get_logger().info("%s", msg)


def annotate(name: str):
    """Named region for the profiler's timeline
    (`torch.profiler.record_function`)."""
    return torch.profiler.record_function(name)
