"""Profiling hooks (PyTorch port of `halogen_tpu/utils/profiling.py`; the
reference's ProfilingScope + RenderDoc workflow): a `torch.profiler` trace
around render calls, the program's named spans on the profiler's timeline,
and one registry of the kernel modules' launch counters.

Spans. `annotate(name)` opens a span where a profiler runs and costs one
check of the profiler's state where none does. The program's spans are
named `halogen.<layer>.<what>`, the layer one of

- `driver`: the frame driver (`Renderer.step`, `render_frame`, the chunks
  and groups of `render_pixels`, the blend, the image's copy to the host);
- `wrap`: the kernel wrappers (the tables and views a launch reads, the
  Autograd Functions around the megakernel and the sky pass, the lockstep
  where it stands in for them);
- `loop`: the fit loop (`fit_materials`: a step's forward, backward, Adam,
  projection and the loss's copy to the host).

A span is a `torch.profiler` CPU event of the function kind, not a user
annotation, so the profiler makes no device row of it and the device's
rows stay the kernels' and copies' own.
"""

from __future__ import annotations

import contextlib
import importlib
import os

import torch

from halogen_tpu_torch.utils.metrics import get_logger

_OFF = contextlib.nullcontext()

# name: (module, global). A launch count, or a count of calls that each
# launch several passes (`*_calls`, passes no other counter counts);
# `megakernel.recorded` counts the launches among `megakernel.launches`
# that recorded the adjoint's transcript, `megakernel.chunk_groups` the
# launch groups among them that the chunk node's calls
# (`megakernel.chunk_nodes`) served; `megakernel.lane_sums` and
# `adjoint.group_sums` the launches of the chunk node's two small kernels
# (`lane_sum` a group, `sum_groups` a backward), kept out of the
# `*launches` names as the sweep's `reduce_blocks` is;
# `trace.wavefront_syncs` the wavefront's host syncs; `sky.atlas_builds`
# the copies of the mips into one atlas (`sky.atlas`), no launch of the
# port's own.
COUNTERS = {
    "megakernel.launches": ("halogen_tpu_torch.kernels.megakernel",
                            "LAUNCHES"),
    "megakernel.recorded": ("halogen_tpu_torch.kernels.megakernel",
                            "RECORD_LAUNCHES"),
    "megakernel.chunk_nodes": ("halogen_tpu_torch.kernels.megakernel",
                               "CHUNK_NODES"),
    "megakernel.chunk_groups": ("halogen_tpu_torch.kernels.megakernel",
                                "CHUNK_GROUPS"),
    "megakernel.lane_sums": ("halogen_tpu_torch.kernels.megakernel",
                             "LANE_SUM_LAUNCHES"),
    "adjoint.replay_launches": ("halogen_tpu_torch.kernels.adjoint",
                                "LAUNCHES"),
    "adjoint.sweep_launches": ("halogen_tpu_torch.kernels.adjoint",
                               "SWEEP_LAUNCHES"),
    "adjoint.group_sums": ("halogen_tpu_torch.kernels.adjoint",
                           "GROUP_SUM_LAUNCHES"),
    "sky.forward_launches": ("halogen_tpu_torch.kernels.sky",
                             "FORWARD_LAUNCHES"),
    "sky.backward_launches": ("halogen_tpu_torch.kernels.sky",
                              "BACKWARD_LAUNCHES"),
    "sky.order_calls": ("halogen_tpu_torch.kernels.sky", "ORDER_LAUNCHES"),
    "sky.sum_calls": ("halogen_tpu_torch.kernels.sky", "SCATTER_LAUNCHES"),
    "sky.atlas_builds": ("halogen_tpu_torch.kernels.sky", "ATLAS_BUILDS"),
    "traverse.launches": ("halogen_tpu_torch.kernels.traverse", "LAUNCHES"),
    "trace.wavefront_syncs": ("halogen_tpu_torch.integrator.trace",
                              "WAVEFRONT_SYNCS"),
}


@contextlib.contextmanager
def trace(log_dir: str = "halogen_trace"):
    """Capture a `torch.profiler` trace of the block (the CPU, and the
    card where there is one) and write it as a Chrome trace,
    `log_dir/trace.json` (open in chrome://tracing or Perfetto), where the
    program's `halogen.*` spans lie above the device's rows. Yields the
    profiler, whose `key_averages()` sums the time by operation and span.

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


def annotate(name: str, args: int | None = None):
    """The span `name` on the profiler's timeline while a profiler runs
    (`args`, an integer such as the frame or step index, is kept where the
    profiler records inputs); else one shared empty context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    if args is None:
        return torch._C._profiler._RecordFunctionFast(name)
    return torch._C._profiler._RecordFunctionFast(name, [args], {})


def counts() -> dict:
    """{name: value} of every counter of `COUNTERS`, read now."""
    return {name: getattr(importlib.import_module(mod), attr)
            for name, (mod, attr) in COUNTERS.items()}
